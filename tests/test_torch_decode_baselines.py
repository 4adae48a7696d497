"""The float and fakequant decode baselines of the port against
``repro.core.attention``'s, on numpy-seeded inputs.

``decode_attention`` over the dense int8 cache, ``paged_decode_attention``
and ``paged_verify_attention`` over the paged pool: in ``"float"`` and
``"fakequant"`` mode both packages dequantize the int8 cache with its
static scales and run the f32 safe softmax under the length mask (and the
window), outside any kernel.  Stated tolerance: attention outputs within
``ATOL = 1e-5`` (outputs are O(1); the two frameworks' f32 exp and sums
differ in the last bits), every shape and edge here (an idle slot of
length 0 gives zeros in both).  Then the TinyLlama smoke model in f32 with
``serve_attn_mode`` float and fakequant: paged prefill + 16 decode logits
within ``DECODE_BASELINE_TOL = 2e-3`` of the logits' scale (the bound
``chip_smoke.py`` holds the card to against the CPU), and served tokens
equal the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import attention as JA
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import attention as TA
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ATOL = 1e-5
DECODE_BASELINE_TOL = 2e-3
MODES = ["float", "fakequant"]


def _cache(rng, b, hkv, s_max, d):
    k = rng.integers(-128, 128, (b, hkv, s_max, d)).astype(np.int8)
    v = rng.integers(-128, 128, (b, hkv, s_max, d)).astype(np.int8)
    return k, v, np.float32(0.021), np.float32(0.017)


def _pages(k, block_k, rng):
    """The dense (B, H, S, D) cache as a shuffled pool and table (block 0
    is the trash block, filled with 127)."""
    b, h, s, d = k.shape
    mb = s // block_k
    ids = rng.permutation(b * mb) + 1
    pool = np.full((1 + b * mb, h, block_k, d), 127, np.int8)
    table = ids.reshape(b, mb).astype(np.int32)
    for i in range(b):
        for j in range(mb):
            pool[table[i, j]] = k[i, :, j * block_k:(j + 1) * block_k]
    return pool, table


def _specs(mode, window):
    return (JA.AttentionSpec(mode=mode, window=window),
            TA.AttentionSpec(mode=mode, window=window))


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hq, hkv, d", [(8, 2, 16), (4, 4, 32)])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_baselines(rng, mode, hq, hkv, d, window):
    b, s_max = 4, 24
    k, v, s_k, s_v = _cache(rng, b, hkv, s_max, d)
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    lens = np.array([0, 1, 17, 24], np.int32)
    jspec, tspec = _specs(mode, window)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.float32(s_k), jnp.float32(s_v),
                               jnp.asarray(lens), jspec)
    got = TA.decode_attention(*_t(q, k, v, s_k, s_v, lens), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert not got[0].any()                    # an idle slot attends nothing


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("window", [None, 7])
def test_paged_decode_attention_baselines(rng, mode, window):
    b, hq, hkv, d, s_max, bk = 3, 8, 2, 16, 32, 8
    k, v, s_k, s_v = _cache(rng, b, hkv, s_max, d)
    kp, table = _pages(k, bk, np.random.default_rng(1))
    vp, _ = _pages(v, bk, np.random.default_rng(1))
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    lens = np.array([9, 32, 1], np.int32)
    jspec, tspec = _specs(mode, window)
    want = JA.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.float32(s_k), jnp.float32(s_v), jnp.asarray(lens), jspec)
    got = TA.paged_decode_attention(*_t(q, kp, vp, table, s_k, s_v, lens),
                                    tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # the same values as the dense baseline over the gathered pool
    dense = TA.decode_attention(*_t(q, k, v, s_k, s_v, lens), tspec)
    torch.testing.assert_close(got, dense, rtol=0, atol=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gamma", [1, 4])
def test_paged_verify_attention_baselines(rng, mode, gamma):
    b, hq, hkv, d, s_max, bk = 2, 8, 2, 16, 32, 8
    k, v, s_k, s_v = _cache(rng, b, hkv, s_max, d)
    kp, table = _pages(k, bk, np.random.default_rng(2))
    vp, _ = _pages(v, bk, np.random.default_rng(2))
    q = rng.normal(0, 1, (b, hq, gamma, d)).astype(np.float32)
    lens = np.array([gamma + 3, 30], np.int32)
    jspec, tspec = _specs(mode, None)
    want = JA.paged_verify_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.float32(s_k), jnp.float32(s_v), jnp.asarray(lens), jspec)
    got = TA.paged_verify_attention(*_t(q, kp, vp, table, s_k, s_v, lens),
                                    tspec)
    assert got.shape == (b, hq, gamma, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # token t is the decode baseline at length lens - (gamma - 1 - t)
    for t in range(gamma):
        row = TA.paged_decode_attention(
            *_t(q[:, :, t], kp, vp, table, s_k, s_v, lens - (gamma - 1 - t)),
            tspec)
        torch.testing.assert_close(got[:, :, t], row, rtol=0, atol=0)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    tcfg = tget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, bridge.from_jax_params(
        jax.device_get(jparams), tcfg, device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_model_logits_in_baseline_modes(smoke, mode):
    jcfg, tcfg, jparams, tparams = smoke
    jcfg, tcfg = (c.replace(serve_attn_mode=mode) for c in (jcfg, tcfg))
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab_size, (1, 20), dtype=np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (16, 1), dtype=np.int32)
    rows = np.arange(1, 6, dtype=np.int32)[None]
    jcache = JT.make_paged_cache(jcfg, 1, 40, block_k=8)
    tcache = TT.make_paged_cache(tcfg, 1, 40, block_k=8, device="cpu")
    jl, jcache = jax.jit(jsteps.make_paged_prefill_step(jcfg, calibrate=True))(
        jparams, jnp.asarray(prompt), jcache, jnp.asarray([0], jnp.int32),
        jnp.asarray(rows))
    tl, tcache = TT.prefill_paged(tparams, torch.from_numpy(prompt), tcfg,
                                  tcache, torch.tensor([0], dtype=torch.int32),
                                  torch.from_numpy(rows), calibrate=True)
    want, got = [np.asarray(jl)], [tl.numpy()]
    jdecode = jax.jit(jsteps.make_decode_step(jcfg))
    for t in range(len(toks)):
        jl, jcache = jdecode(jparams, jnp.asarray(toks[t]), jcache)
        tl, tcache = TT.decode_step(tparams, torch.from_numpy(toks[t]), tcfg,
                                    tcache)
        want.append(np.asarray(jl))
        got.append(tl.numpy())
    want, got = np.concatenate(want), np.concatenate(got)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_BASELINE_TOL
                               * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
def test_serve_tokens_in_baseline_modes(smoke, mode):
    jcfg, tcfg, jparams, tparams = smoke
    jcfg, tcfg = (c.replace(serve_attn_mode=mode) for c in (jcfg, tcfg))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, 24, dtype=np.int32)
               for _ in range(6)]
    gens = [int(g) for g in rng.integers(8, 17, 6)]
    kw = dict(slots=3, gen=16, gens=gens, block_k=8)
    want = jserve.serve(jparams, jcfg, prompts, **kw)
    got = tserve.serve(tparams, tcfg, prompts, **kw)
    assert got["finished"] == want["finished"]
