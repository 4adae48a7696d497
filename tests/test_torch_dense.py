"""The dense-cache slice of the port against the JAX reference: the dense
decode kernels (fused and composed), the dense verify, the dense model
path with its sliding-window ring buffer, and ``--cache dense`` serving.

Layers of evidence, as for the paged path:

  * **kernels**: the plain versions of the fused and composed dense decode
    and the dense verify against ``repro.kernels.ops`` in its ``xla``
    implementation, on the same numpy inputs.  f32 outputs agree to
    ``rtol = atol = 2e-5``, the reference's own kernel-test tolerance,
    because the e*V and denominator sums are taken in another order.
    Within the port the composed decode equals the fused one, a dense slot
    equals a paged slot holding the same K/V, and every verify row equals
    the fused decode at its effective length, ``torch.equal``;
  * **model**: a batch-wide prefill with ragged ``valid_len`` and 8 decode
    steps on the dense cache, a ring buffer wrapped twice, and writes past
    the cache's end, against JAX ``prefill``/``decode_step``: logits within
    1e-3 of their largest magnitude (the tolerance of
    ``tests/test_torch_model.py``), lengths and scales equal;
  * **serving**: greedy ``serve_dense`` token streams and its batch-prefill
    and decode-step counts equal JAX ``serve_dense``, fused and composed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import lut as jlut
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import paged_kv
from repro_torch.core import quantization as tq
from repro_torch.core.lut import LUTConfig as TLUTConfig
from repro_torch.core.lut import build_exp_lut, build_recip_lut
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

SCALE_Z = 2.6 / 127
JCFG = jlut.LUTConfig(scale_z=SCALE_Z)
TCFG = TLUTConfig(scale_z=SCALE_Z)
EXP, RECIP = build_exp_lut(TCFG), build_recip_lut(TCFG)
SCALES = (np.float32(0.01), np.float32(0.012), np.float32(0.02))
TOL = dict(rtol=2e-5, atol=2e-5)

DECODE_GRID = [
    # b, hq, hkv, s_max, d  (tests/test_kernels.py's grid, plus a cache no
    # tile divides: the churn's max_len)
    (2, 4, 2, 256, 64),
    (1, 8, 1, 128, 128),
    (3, 6, 6, 384, 64),
    (2, 8, 2, 290, 64),
]


def _t(x):
    return torch.from_numpy(np.array(x))


def _cache(rng, b, hkv, s_max, d):
    k = rng.integers(-128, 128, (b, hkv, s_max, d)).astype(np.int8)
    v = rng.integers(-128, 128, (b, hkv, s_max, d)).astype(np.int8)
    return k, v


# ------------------------------------------------------------------ kernels --

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("shape", DECODE_GRID)
def test_dense_decode_plain_matches_xla(rng, shape, window, fused):
    b, hq, hkv, s, d = shape
    k, v = _cache(rng, b, hkv, s, d)
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    tail = (SCALES[1], SCALES[2], lens, EXP, RECIP)
    if fused:
        q = rng.normal(0, 0.5, (b, hq, d)).astype(np.float32)
        s_q = rng.uniform(0.008, 0.02, (b,)).astype(np.float32)
        jfn, tfn = jops.splitmax_decode_fused, tops.splitmax_decode_fused
    else:
        q = rng.integers(-128, 128, (b, hq, d)).astype(np.int8)
        s_q = SCALES[0]
        jfn, tfn = jops.splitmax_decode, tops.splitmax_decode
    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), s_q, *tail,
               cfg=JCFG, window=window, impl="xla")
    got = tfn(_t(q), _t(k), _t(v), _t(s_q), *(_t(x) for x in tail),
              cfg=TCFG, window=window)
    assert got.shape == (b, hq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, 48])
def test_dense_fused_equals_composed_and_paged(rng, window):
    """Composed on quantize(q, s_q) == fused; and a dense slot == the same
    K/V scattered through a shuffled pool at an equal extent, bit for bit.
    One slot sits on a tile boundary, one is idle-like (length 1)."""
    b, hq, hkv, d, bk, mb = 4, 8, 2, 64, 32, 9
    s_max = mb * bk
    k, v = _cache(rng, b, hkv, s_max, d)
    lens = np.array([1, bk, 2 * bk + 5, s_max], np.int32)
    q = _t(rng.normal(0, 0.5, (b, hq, d)).astype(np.float32))
    s_q = tq.absmax_scale(q, axis=(1, 2)).reshape(-1)
    tail = (_t(SCALES[1]), _t(SCALES[2]), _t(lens), _t(EXP), _t(RECIP))
    fused = tops.splitmax_decode_fused(q, _t(k), _t(v), s_q, *tail, cfg=TCFG,
                                       window=window)
    composed = tops.splitmax_decode(tq.quantize(q, s_q[:, None, None]),
                                    _t(k), _t(v), s_q, *tail, cfg=TCFG,
                                    window=window)
    assert torch.equal(fused, composed)

    nb = 1 + b * mb
    table = rng.permutation(np.arange(1, nb)).reshape(b, mb).astype(np.int32)
    kp = np.zeros((nb, hkv, bk, d), np.int8)
    vp = np.zeros((nb, hkv, bk, d), np.int8)
    for i in range(b):
        for j in range(mb):
            kp[table[i, j]] = k[i, :, j * bk:(j + 1) * bk]
            vp[table[i, j]] = v[i, :, j * bk:(j + 1) * bk]
    paged = tops.splitmax_decode_fused_paged(q, _t(kp), _t(vp), _t(table),
                                             s_q, *tail, cfg=TCFG,
                                             window=window)
    assert torch.equal(fused, paged)
    assert torch.equal(_t(k), paged_kv.gather_kv(_t(kp), _t(table)))


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("gamma", [2, 4])
def test_dense_verify_plain_matches_xla_and_per_token_decode(gamma, window):
    rng = np.random.default_rng(gamma * 10 + (window or 0))
    b, hq, hkv, s, d = 3, 8, 2, 200, 64
    k, v = _cache(rng, b, hkv, s, d)
    q = rng.normal(0, 0.5, (b, hq, gamma, d)).astype(np.float32)
    s_q = rng.uniform(0.008, 0.02, (b, gamma)).astype(np.float32)
    lens = np.array([gamma, 97, s], np.int32)
    tail = (SCALES[1], SCALES[2], lens, EXP, RECIP)
    want = jops.splitmax_decode_fused_verify(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(s_q),
        *tail, cfg=JCFG, window=window, impl="xla")
    got = tops.splitmax_decode_fused_verify(
        _t(q), _t(k), _t(v), _t(s_q), *(_t(x) for x in tail), cfg=TCFG,
        window=window)
    assert got.shape == (b, hq, gamma, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(gamma):
        row = tops.splitmax_decode_fused(
            _t(q[:, :, t]), _t(k), _t(v), _t(s_q[:, t]), _t(SCALES[1]),
            _t(SCALES[2]), _t(lens - (gamma - 1 - t)), _t(EXP), _t(RECIP),
            cfg=TCFG, window=window)
        assert torch.equal(got[:, :, t], row)


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("gamma,d", [(16, 64), (8, 128)])
def test_dense_verify_plain_matches_xla_at_a_full_group(gamma, d, window):
    """Group 8 x T x D past the first verify kernel's cap of 4096 outputs,
    which refused both shapes."""
    rng = np.random.default_rng(gamma * 1000 + d)
    b, hq, hkv, s = 2, 8, 1, 290
    k, v = _cache(rng, b, hkv, s, d)
    q = rng.normal(0, 0.5, (b, hq, gamma, d)).astype(np.float32)
    s_q = rng.uniform(0.008, 0.02, (b, gamma)).astype(np.float32)
    lens = np.array([gamma + 1, s], np.int32)
    tail = (SCALES[1], SCALES[2], lens, EXP, RECIP)
    want = jops.splitmax_decode_fused_verify(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(s_q),
        *tail, cfg=JCFG, window=window, impl="xla")
    got = tops.splitmax_decode_fused_verify(
        _t(q), _t(k), _t(v), _t(s_q), *(_t(x) for x in tail), cfg=TCFG,
        window=window)
    assert got.shape == (b, hq, gamma, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(gamma):
        row = tops.splitmax_decode_fused(
            _t(q[:, :, t]), _t(k), _t(v), _t(s_q[:, t]), _t(SCALES[1]),
            _t(SCALES[2]), _t(lens - (gamma - 1 - t)), _t(EXP), _t(RECIP),
            cfg=TCFG, window=window)
        assert torch.equal(got[:, :, t], row)


def test_dense_cuda_wrappers_refuse_cpu_tensors(rng):
    from repro_torch.kernels import splitmax_decode as K
    k, v = _cache(rng, 1, 1, 32, 16)
    args = (_t(np.zeros((1, 1, 16), np.float32)), _t(k), _t(v))
    with pytest.raises(ValueError, match="CUDA"):
        K.splitmax_decode_fused_cuda(*args, None, None, None, None, None,
                                     None, cfg=TCFG)
    with pytest.raises(ValueError, match="CUDA"):
        K.splitmax_decode_fused_verify_cuda(args[0][:, :, None], *args[1:],
                                            None, None, None, None, None,
                                            None, cfg=TCFG)


# -------------------------------------------------------------------- model --

@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    tcfg = tget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(0))
    tparams = bridge.from_jax_params(jax.device_get(jparams), tcfg,
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


def _run_both(smoke, *, slots, prompt_len, max_len, steps, valid_len=None,
              window=None, fused=True, seed=3):
    """Prefill + ``steps`` decode steps on a dense cache in both packages;
    returns (jax logits, port logits, jax cache, port cache)."""
    jcfg, jparams, tcfg, tparams = smoke
    jcfg = jcfg.replace(window=window, attn_fused=fused)
    tcfg = tcfg.replace(window=window, attn_fused=fused)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, jcfg.vocab_size, (slots, prompt_len),
                           dtype=np.int32)
    steps_tok = rng.integers(0, jcfg.vocab_size, (steps, slots),
                             dtype=np.int32)
    jvl = None if valid_len is None else jnp.asarray(valid_len, jnp.int32)
    tvl = None if valid_len is None else torch.tensor(valid_len,
                                                      dtype=torch.int32)
    jprefill = jax.jit(lambda p, t, vl: JT.prefill(
        p, t, jcfg, JT.make_cache(jcfg, slots, max_len), valid_len=vl))
    jl, jcache = jprefill(jparams, jnp.asarray(prompts), jvl)
    tl, tcache = TT.prefill(tparams, torch.from_numpy(prompts), tcfg,
                            TT.make_cache(tcfg, slots, max_len, device="cpu"),
                            valid_len=tvl)
    jlogits, tlogits = [np.asarray(jl)], [tl.numpy()]
    jdecode = jax.jit(jsteps.make_decode_step(jcfg))
    for t in range(steps):
        jl, jcache = jdecode(jparams, jnp.asarray(steps_tok[t]), jcache)
        tl, tcache = TT.decode_step(tparams, torch.from_numpy(steps_tok[t]),
                                    tcfg, tcache)
        jlogits.append(np.asarray(jl))
        tlogits.append(tl.numpy())
    return np.stack(jlogits), np.stack(tlogits), jcache, tcache


def _assert_close(jall, tall, jcache, tcache):
    assert tall.shape == jall.shape
    assert np.isfinite(tall).all()
    np.testing.assert_allclose(tall, jall, rtol=0,
                               atol=1e-3 * np.abs(jall).max())
    jkv = jcache["kv"]
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jkv["length"]))
    np.testing.assert_allclose(tcache["scale_k"].numpy(),
                               np.asarray(jkv["scale_k"]), rtol=1e-6)
    np.testing.assert_allclose(tcache["scale_v"].numpy(),
                               np.asarray(jkv["scale_v"]), rtol=1e-6)
    for name in ("k_q", "v_q"):
        diff = np.abs(tcache[name].numpy().astype(np.int32)
                      - np.asarray(jkv[name]).astype(np.int32))
        assert diff.max() <= 1, name
        assert (diff != 0).mean() < 1e-3, name


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
def test_dense_prefill_and_decode_match(smoke, fused):
    """A padded batch (ragged valid_len, one idle-like row of length 1),
    calibrated batch-wide, then 8 decode steps."""
    jall, tall, jcache, tcache = _run_both(
        smoke, slots=3, prompt_len=20, max_len=36, steps=8,
        valid_len=[20, 13, 1], fused=fused)
    _assert_close(jall, tall, jcache, tcache)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
def test_ring_buffer_wraps_twice(smoke, fused):
    """Window 16 over a 16-position ring, a 32-token prompt (the ring keeps
    its last 16), then 33 decode steps: the write index wraps twice."""
    jall, tall, jcache, tcache = _run_both(
        smoke, slots=2, prompt_len=32, max_len=16, steps=33, window=16,
        fused=fused)
    assert tcache["k_q"].shape[3] == 16
    _assert_close(jall, tall, jcache, tcache)


def test_ring_prefill_needs_a_multiple_of_the_ring(smoke):
    _, _, tcfg, tparams = smoke
    tcfg = tcfg.replace(window=16)
    tokens = torch.zeros((1, 24), dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple"):
        TT.prefill(tparams, tokens, tcfg,
                   TT.make_cache(tcfg, 1, 16, device="cpu"))


def test_writes_past_the_cache_are_dropped(smoke):
    """A dense cache two positions longer than the prompt, decoded 5 steps:
    the last 3 writes fall outside it and are dropped, as the reference's
    out-of-bounds scatter drops them; the attention length keeps growing
    and is masked at the cache's end."""
    jall, tall, jcache, tcache = _run_both(
        smoke, slots=2, prompt_len=12, max_len=14, steps=5)
    _assert_close(jall, tall, jcache, tcache)
    assert tcache["length"].tolist() == [17, 17]


# ------------------------------------------------------------------ serving --

def _prompts_gens(requests, prompt_len, gen, seed, vocab):
    """benchmarks/serve_bench.py's churn workload: gens staggered in
    [gen/2, gen] so retirements never synchronize."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, prompt_len, dtype=np.int32)
               for _ in range(requests)]
    gens = [int(g) for g in rng.integers(gen // 2, gen + 1, requests)]
    return prompts, gens


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
@pytest.mark.parametrize("seed,slots,prompt_len", [(0, 3, 20), (1, 4, 29)])
def test_serve_dense_tokens_equal_reference(smoke, seed, slots, prompt_len,
                                            fused):
    jcfg, jparams, tcfg, tparams = smoke
    jcfg, tcfg = (c.replace(attn_fused=fused) for c in (jcfg, tcfg))
    prompts, gens = _prompts_gens(9, prompt_len, 12, seed, jcfg.vocab_size)
    want = jserve.serve_dense(jparams, jcfg, prompts, slots=slots, gen=12,
                              gens=gens)
    got = tserve.serve(tparams, tcfg, prompts, slots=slots, gen=12,
                       gens=gens, cache_kind="dense")
    assert got["finished"] == want["finished"]
    assert got["served"] == want["served"] == len(prompts)
    assert got["batch_prefills"] == want["batch_prefills"] > 1
    assert got["decode_steps"] == want["decode_steps"]
    assert got["kv_bytes_per_step"] == want["kv_bytes_per_step"]
    assert got["slot_prefills"] == 0 and got["leaked_blocks"] == 0
    assert got["total_tokens"] == want["total_tokens"]
    # the reference emits one token more than asked for a request whose
    # last token comes from a re-prefill (the next decode step appends one
    # before the retirement check); the port keeps its token streams
    for rid, toks in got["finished"].items():
        assert gens[rid] <= len(toks) <= gens[rid] + 1
    assert got["p99_step_ms"] >= got["p50_step_ms"] > 0


@pytest.mark.parametrize("flags", [[], ["--fused", "off"]],
                         ids=["fused", "composed"])
def test_cli_serves_dense_on_cpu(capsys, flags):
    tserve.main(["--smoke", "--device", "cpu", "--cache", "dense",
                 "--requests", "3", "--slots", "2", "--prompt-len", "10",
                 "--gen", "4", *flags])
    out = capsys.readouterr().out
    assert "[dense:dense:cpu] served 3 requests, 12 tokens" in out
    assert "batch prefills" in out


def test_dense_rejects_paged_options(smoke):
    _, _, tcfg, tparams = smoke
    prompts, _ = _prompts_gens(2, 10, 4, 0, tcfg.vocab_size)
    with pytest.raises(ValueError, match="pool_blocks"):
        tserve.serve(tparams, tcfg, prompts, slots=2, gen=4,
                     cache_kind="dense", pool_blocks=8)
    with pytest.raises(ValueError, match="paged-only"):
        tserve.serve(tparams, tcfg, prompts, slots=2, gen=4,
                     cache_kind="dense", draft="self")
    with pytest.raises(ValueError, match="cache_kind"):
        tserve.serve(tparams, tcfg, prompts, slots=2, gen=4,
                     cache_kind="ring")


def test_dense_entry_points_do_not_fall_back_to_cpu(smoke):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    _, _, tcfg, _ = smoke
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.make_cache(tcfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--smoke", "--cache", "dense", "--requests", "2"])
