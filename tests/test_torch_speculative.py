"""Speculative serving and the composed paged decode of the port against the
JAX reference (mirrors ``tests/test_speculative.py`` and the speculative
half of ``tests/test_overcommit.py``).

Layers of evidence, as in the reference:

  * **kernels**: the plain versions of the paged verify and the composed
    paged decode against ``repro.kernels.ops`` (``xla`` and ``interpret``)
    on the same numpy inputs.  The int8 query of every token is equal; f32
    outputs agree to ``rtol = atol = 2e-5``, the reference's own kernel-test
    tolerance, because the e*V and denominator sums are taken in another
    order.  Within the port, every verify row equals the fused decode at its
    effective length, and the composed decode equals the fused one,
    ``torch.equal``;
  * **model**: ``verify_step`` logits equal T sequential ``decode_step``
    logits of the port, and match JAX ``verify_step`` within 1e-3 of their
    largest magnitude (the tolerance of ``tests/test_torch_model.py``);
  * **serving**: speculative token streams for self, layer-prefix and
    random-weights drafters, and under an over-committed pool with parks and
    preemptions, equal JAX ``serve(..., draft=...)`` and the port's plain
    ``serve_paged``, with no leaked block; ``--fused off`` serves the fused
    tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import lut as jlut
from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import quantization as tq
from repro_torch.core.lut import LUTConfig as TLUTConfig
from repro_torch.core.lut import build_exp_lut, build_recip_lut
from repro_torch.kernels import ops as tops
from repro_torch.kernels import splitmax_decode as K
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

SCALE_Z = 2.6 / 127
JCFG = jlut.LUTConfig(scale_z=SCALE_Z)
TCFG = TLUTConfig(scale_z=SCALE_Z)
EXP, RECIP = build_exp_lut(TCFG), build_recip_lut(TCFG)
S_K, S_V = np.float32(0.011), np.float32(0.02)
TOL = dict(rtol=2e-5, atol=2e-5)
S_MAX, BLOCK_K = 256, 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _verify_inputs(seed, gamma, d, *, b=2, hq=4, hkv=2):
    """test_speculative.py's inputs on a shuffled paged pool: per-(slot,
    token) scales all distinct, odd lengths >= gamma."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 0.5, (b, hq, gamma, d)).astype(np.float32)
    mb = S_MAX // BLOCK_K
    nb = 1 + b * mb
    kp = rng.integers(-128, 128, (nb, hkv, BLOCK_K, d)).astype(np.int8)
    vp = rng.integers(-128, 128, (nb, hkv, BLOCK_K, d)).astype(np.int8)
    table = rng.permutation(np.arange(1, nb)).reshape(b, mb).astype(np.int32)
    s_q = rng.uniform(0.008, 0.02, (b, gamma)).astype(np.float32)
    lens = np.minimum(rng.integers(gamma, S_MAX, (b,)) | 1, S_MAX - 1)
    return q, kp, vp, table, s_q, lens.astype(np.int32)


def _verify_both(q, kp, vp, table, s_q, lens, *, window, impl):
    want = jops.splitmax_decode_fused_verify_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(s_q), S_K, S_V, jnp.asarray(lens), EXP, RECIP, cfg=JCFG,
        window=window, impl=impl)
    got = tops.splitmax_decode_fused_verify_paged(
        _t(q), _t(kp), _t(vp), _t(table), _t(s_q), _t(S_K), _t(S_V),
        _t(lens), _t(EXP), _t(RECIP), cfg=TCFG, window=window)
    return got, np.asarray(want)


@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("gamma", [2, 4, 8])
def test_verify_plain_matches_xla_and_per_token_decode(gamma, d, window):
    q, kp, vp, table, s_q, lens = _verify_inputs(gamma * 100 + d, gamma, d)
    got, want = _verify_both(q, kp, vp, table, s_q, lens, window=window,
                             impl="xla")
    assert got.shape == (2, 4, gamma, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for t in range(gamma):
        # the int8 query of every token is the reference's
        np.testing.assert_array_equal(
            tq.quantize(_t(q[:, :, t]), _t(s_q[:, t])[:, None, None]).numpy(),
            np.asarray(jq.quantize(jnp.asarray(q[:, :, t]),
                                   jnp.asarray(s_q[:, t])[:, None, None])))
        # each row is the port's own decode at its effective length
        row = tops.splitmax_decode_fused_paged(
            _t(q[:, :, t]), _t(kp), _t(vp), _t(table), _t(s_q[:, t]),
            _t(S_K), _t(S_V), _t(lens - (gamma - 1 - t)), _t(EXP), _t(RECIP),
            cfg=TCFG, window=window)
        assert torch.equal(got[:, :, t], row)


# group 8 x T x D past the first verify kernel's cap of 4096 (256 threads x
# 16 outputs), which refused both: T 16 at D 64, and T 8 at D 128
FULL_GROUP = [(16, 64), (8, 128)]


@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("gamma,d", FULL_GROUP)
def test_verify_plain_matches_xla_at_a_full_group(gamma, d, window):
    q, kp, vp, table, s_q, lens = _verify_inputs(gamma * 10 + d, gamma, d,
                                                 hq=8, hkv=1)
    got, want = _verify_both(q, kp, vp, table, s_q, lens, window=window,
                             impl="xla")
    assert got.shape == (2, 8, gamma, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for t in range(gamma):
        row = tops.splitmax_decode_fused_paged(
            _t(q[:, :, t]), _t(kp), _t(vp), _t(table), _t(s_q[:, t]),
            _t(S_K), _t(S_V), _t(lens - (gamma - 1 - t)), _t(EXP), _t(RECIP),
            cfg=TCFG, window=window)
        assert torch.equal(got[:, :, t], row)


@pytest.mark.parametrize("window", [None, 24])
def test_verify_plain_matches_interpret(window):
    """The Pallas verify kernel body itself (interpret mode)."""
    q, kp, vp, table, s_q, lens = _verify_inputs(5, 4, 16)
    got, want = _verify_both(q, kp, vp, table, s_q, lens, window=window,
                             impl="interpret")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_verify_accepts_per_token_scale():
    """A (T,) scale (one per token, shared by the slots) broadcasts to the
    (B, T) contract rather than being read as per-slot."""
    q, kp, vp, table, s_q, lens = _verify_inputs(7, 4, 64)
    args = (_t(kp), _t(vp), _t(table))
    tail = (_t(S_K), _t(S_V), _t(lens), _t(EXP), _t(RECIP))
    shared = tops.splitmax_decode_fused_verify_paged(
        _t(q), *args, _t(s_q[0]), *tail, cfg=TCFG)
    full = tops.splitmax_decode_fused_verify_paged(
        _t(q), *args, _t(np.broadcast_to(s_q[0], s_q.shape)), *tail, cfg=TCFG)
    assert torch.equal(shared, full)


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("shape", [(3, 8, 2, 16), (4, 32, 4, 64)])
def test_composed_plain_matches_xla_and_fused(shape, window):
    b, hq, hkv, d = shape
    rng = np.random.default_rng(b * d)
    mb, bk = 3, 32
    nb = 1 + b * mb
    kp = rng.integers(-128, 128, (nb, hkv, bk, d)).astype(np.int8)
    vp = rng.integers(-128, 128, (nb, hkv, bk, d)).astype(np.int8)
    table = rng.permutation(np.arange(1, nb)).reshape(b, mb).astype(np.int32)
    lens = np.array([1 + (i * 37) % (mb * bk) for i in range(b)], np.int32)
    lens[0] = bk
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    s_q = tq.absmax_scale(_t(q), axis=(1, 2))
    q_q = tq.quantize(_t(q), s_q)
    pool = (_t(kp), _t(vp), _t(table))
    tail = (_t(S_K), _t(S_V), _t(lens), _t(EXP), _t(RECIP))
    got = tops.splitmax_decode_paged(q_q, *pool, s_q, *tail, cfg=TCFG,
                                     window=window)
    want = jops.splitmax_decode_paged(
        jnp.asarray(q_q.numpy()), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(s_q.numpy()), S_K, S_V,
        jnp.asarray(lens), EXP, RECIP, cfg=JCFG, window=window, impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    fused = tops.splitmax_decode_fused_paged(_t(q), *pool, s_q, *tail,
                                             cfg=TCFG, window=window)
    assert torch.equal(got, fused)


def test_cpu_tensors_take_plain_and_count_no_launch():
    K.composed_launches = K.verify_launches = 0
    test_verify_accepts_per_token_scale()
    test_composed_plain_matches_xla_and_fused((3, 8, 2, 16), None)
    assert K.composed_launches == 0 and K.verify_launches == 0
    with pytest.raises(ValueError):
        K.splitmax_decode_fused_verify_paged_cuda(
            torch.zeros(1, 2, 2, 16), torch.zeros(3, 1, 8, 16, dtype=torch.int8),
            torch.zeros(3, 1, 8, 16, dtype=torch.int8),
            torch.ones(1, 2, dtype=torch.int32), torch.ones(1, 2),
            torch.ones(1, 2), torch.tensor(0.01),
            torch.ones(1, dtype=torch.int32), _t(EXP), _t(RECIP), cfg=TCFG)
    with pytest.raises(ValueError):
        K.splitmax_decode_paged_cuda(
            torch.zeros(1, 2, 16, dtype=torch.int8),
            torch.zeros(3, 1, 8, 16, dtype=torch.int8),
            torch.zeros(3, 1, 8, 16, dtype=torch.int8),
            torch.ones(1, 2, dtype=torch.int32), torch.ones(1),
            torch.tensor(0.01), torch.ones(1, dtype=torch.int32), _t(EXP),
            _t(RECIP), cfg=TCFG)


# ------------------------------------------------------------------ model --

SLOTS, PROMPT, GAMMA, MB_K = 2, 13, 4, 8
MAX_LEN = PROMPT + GAMMA + 8


def _bridged(key):
    jcfg = jget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    tcfg = tget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(key))
    tparams = bridge.from_jax_params(jax.device_get(jparams), tcfg,
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_verify_step_equals_sequential_decode_and_reference():
    jcfg, jparams, tcfg, tparams = _bridged(0)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, jcfg.vocab_size, (SLOTS, PROMPT), dtype=np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (SLOTS, GAMMA), dtype=np.int32)
    bps = -(-MAX_LEN // MB_K)
    rows = np.arange(1, 1 + SLOTS * bps, dtype=np.int32).reshape(SLOTS, bps)
    rows = rows[:, ::-1].copy()
    jcache = JT.make_paged_cache(jcfg, SLOTS, MAX_LEN, block_k=MB_K)
    tcache = TT.make_paged_cache(tcfg, SLOTS, MAX_LEN, block_k=MB_K,
                                 device="cpu")
    for slot in range(SLOTS):
        step = jax.jit(jsteps.make_paged_prefill_step(jcfg,
                                                      calibrate=slot == 0))
        _, jcache = step(jparams, jnp.asarray(prompts[slot:slot + 1]), jcache,
                         jnp.asarray([slot], jnp.int32),
                         jnp.asarray(rows[slot:slot + 1]))
        TT.prefill_paged(tparams, _t(prompts[slot:slot + 1]), tcfg, tcache,
                         torch.tensor([slot], dtype=torch.int32),
                         _t(rows[slot:slot + 1]), calibrate=slot == 0)
    seq_cache = {k: v.clone() for k, v in tcache.items()}

    logits, tcache = TT.verify_step(tparams, _t(tokens), tcfg, tcache)
    assert logits.shape == (SLOTS, GAMMA, 512)
    assert logits.dtype == torch.float32
    for t in range(GAMMA):
        step_logits, seq_cache = TT.decode_step(tparams, _t(tokens[:, t]),
                                                tcfg, seq_cache)
        assert torch.equal(logits[:, t], step_logits), t
    for name in ("k_pages", "v_pages", "length", "block_table"):
        assert torch.equal(tcache[name], seq_cache[name]), name
    assert tcache["length"].tolist() == [PROMPT + GAMMA] * SLOTS

    jlogits, jcache = jax.jit(jsteps.make_verify_step(jcfg))(
        jparams, jnp.asarray(tokens), jcache)
    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                               atol=1e-3 * np.abs(jlogits).max())
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["kv"]["length"]))


def test_self_draft_prefix_slicing():
    tcfg = tget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    params = TT.init_params(tcfg, seed=0, device="cpu")
    dparams, dcfg = tserve.make_self_draft(params, tcfg, 1)
    assert dcfg.n_layers == 1 and len(dparams["layers"]) == 1
    assert dparams["layers"][0] is params["layers"][0]
    assert dparams["lm_head"] is params["lm_head"]
    whole, wcfg = tserve.make_self_draft(params, tcfg, None)
    assert whole is params and wcfg is tcfg
    with pytest.raises(ValueError):
        tserve.make_self_draft(params, tcfg, 3)


# ---------------------------------------------------------------- serving --

@pytest.fixture(scope="module")
def spec_case():
    """test_speculative.py's serving case: smoke model, 5 prompts of 8
    tokens over 2 slots, staggered gens (retirement churn), block_k 8."""
    jcfg, jparams, tcfg, tparams = _bridged(3)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, 8, dtype=np.int32)
               for _ in range(5)]
    gens = [4, 3, 4, 2, 4]
    plain = tserve.serve_paged(tparams, tcfg, prompts, slots=2, gen=4,
                               gens=gens, block_k=8)
    return jcfg, jparams, tcfg, tparams, prompts, gens, plain


@pytest.mark.parametrize("gamma", [2, 3])
@pytest.mark.parametrize("name", ["self", "prefix", "garbage"])
def test_speculative_serve_tokens_equal_reference_and_plain(spec_case, name,
                                                            gamma):
    jcfg, jparams, tcfg, tparams, prompts, gens, plain = spec_case
    if name == "self":
        jdraft = tdraft = "self"
    elif name == "prefix":
        jdraft = jserve.make_self_draft(jparams, jcfg, 1)
        tdraft = tserve.make_self_draft(tparams, tcfg, 1)
    else:                            # random weights: rejections dominate
        gj = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(99))
        jdraft = (gj, jcfg)
        tdraft = (bridge.from_jax_params(jax.device_get(gj), tcfg,
                                         device="cpu"), tcfg)
    kw = dict(slots=2, gen=4, gens=gens, block_k=8, draft=None, gamma=gamma)
    want = jserve.serve(jparams, jcfg, prompts, cache_kind="paged",
                        **dict(kw, draft=jdraft))
    got = tserve.serve(tparams, tcfg, prompts, **dict(kw, draft=tdraft))
    assert got["finished"] == want["finished"] == plain["finished"]
    assert got["leaked_blocks"] == 0
    assert got["served"] == len(prompts) and not got["failed"]
    assert got["verify_steps"] == got["draft_steps"] > 0
    assert got["slot_prefills"] == len(prompts) * (1 if name == "self" else 2)
    # the correction token guarantees >= 1 emitted token per verify
    assert got["tokens_per_verify"] >= 1.0
    if name == "self":
        assert got["accept_rate"] == want["accept_rate"]


@pytest.mark.parametrize("policy", ["newest", "longest"])
@pytest.mark.parametrize("name", ["self", "prefix"])
def test_overcommit_speculative_tokens_equal_plain(name, policy):
    """test_overcommit.py's speculative case: a 7-block pool for ~1.4
    sequences over 2 slots.  Parking absorbs mild pressure, preemption and
    resume the rest, and the tokens stay the plain greedy tokens."""
    _, _, tcfg, tparams = _bridged(2)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, 16, dtype=np.int32)
               for _ in range(3)]
    gens = [12, 12, 12]
    plain = tserve.serve_paged(tparams, tcfg, prompts, slots=2, gen=12,
                               gens=gens, block_k=8)
    draft = "self" if name == "self" else tserve.make_self_draft(
        tparams, tcfg, 1)
    spec = tserve.serve(tparams, tcfg, prompts, slots=2, gen=12, gens=gens,
                        block_k=8, draft=draft, gamma=3, pool_blocks=7)
    spec_ref = tserve.serve_speculative(
        tparams, tcfg, prompts, slots=2, gen=12, gens=gens, block_k=8,
        draft=None if draft == "self" else draft, gamma=3, pool_blocks=7,
        preempt_policy=policy)
    for stats in (spec, spec_ref):
        assert stats["finished"] == plain["finished"]
        assert stats["leaked_blocks"] == 0       # both pools drained
        assert stats["preemptions"] > 0 and stats["spec_parks"] > 0
        assert stats["resumes"] == stats["preemptions"]


def test_composed_serving_equals_fused():
    _, _, tcfg, tparams = _bridged(0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, 20, dtype=np.int32)
               for _ in range(6)]
    gens = [int(g) for g in rng.integers(6, 13, 6)]
    fused = tserve.serve_paged(tparams, tcfg, prompts, slots=3, gen=12,
                               gens=gens, block_k=8)
    composed = tserve.serve_paged(tparams, tcfg.replace(attn_fused=False),
                                  prompts, slots=3, gen=12, gens=gens,
                                  block_k=8)
    assert composed["finished"] == fused["finished"]
    assert composed["leaked_blocks"] == 0
    spec = tserve.serve(tparams, tcfg.replace(attn_fused=False), prompts,
                        slots=3, gen=12, gens=gens, block_k=8, draft="self",
                        gamma=3)
    assert spec["finished"] == fused["finished"]


@pytest.mark.parametrize("flags", [["--draft", "self", "--gamma", "3"],
                                   ["--fused", "off"],
                                   ["--draft", "self:1", "--pool-blocks", "7"]])
def test_cli_serves_on_cpu(capsys, flags):
    tserve.main(["--smoke", "--device", "cpu", "--requests", "3", "--slots",
                 "2", "--prompt-len", "10", "--gen", "6", "--block-k", "8",
                 *flags])
    out = capsys.readouterr().out
    assert "served 3 requests, 18 tokens" in out
    assert "0 leaked blocks" in out
    if "--draft" in flags:
        assert "accept_rate=" in out and "verify rounds" in out
