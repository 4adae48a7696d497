"""Dense model of the PyTorch port against ``repro.models.transformer`` on
the TinyLlama smoke config in float32 (as ``serve.py --smoke`` runs it).

Parameters come from ``repro.launch.steps.init_params_fn(SMOKE)`` and cross
through ``repro_torch.bridge``.  Both packages prefill two slots through
the paged pool and then take 32 paged decode steps on the same tokens.
Tolerance: logits within 1e-3 of their largest magnitude.  The two
frameworks' f32 matmuls, rsqrt and RoPE differ in the last bits; those
bits can move an int8 K/V value that sits on a rounding edge by one step,
and that step moves logits by ~1e-4 of their scale.  The pool's int8
contents therefore agree to one step, almost everywhere exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

SLOTS, PROMPT, STEPS, BLOCK_K = 2, 20, 32, 8
MAX_LEN = PROMPT + STEPS + 8


@pytest.fixture(scope="module")
def models():
    jcfg = jget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    tcfg = tget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(0))
    tparams = bridge.from_jax_params(jax.device_get(jparams), tcfg,
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_bridge_layout(models):
    jcfg, jparams, tcfg, tparams = models
    seg = jparams["segments"][0]
    assert len(tparams["layers"]) == tcfg.n_layers
    for i in range(tcfg.n_layers):
        np.testing.assert_array_equal(
            tparams["layers"][i]["attn"]["wq"]["w"].numpy(),
            np.asarray(seg["attn"]["wq"]["w"][i]))
        np.testing.assert_array_equal(
            tparams["layers"][i]["mlp"]["w_out"]["w"].numpy(),
            np.asarray(seg["mlp"]["w_out"]["w"][i]))
    assert tparams["lm_head"]["w"].shape == (tcfg.d_model, 512)
    assert tparams["embed"]["table"].dtype == torch.float32


def test_prefill_and_decode_logits_match(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, jcfg.vocab_size, (SLOTS, PROMPT), dtype=np.int32)
    steps_tok = rng.integers(0, jcfg.vocab_size, (STEPS, SLOTS), dtype=np.int32)
    bps = -(-MAX_LEN // BLOCK_K)
    rows = np.arange(1, 1 + SLOTS * bps, dtype=np.int32).reshape(SLOTS, bps)
    rows = rows[:, ::-1].copy()                    # non-monotone block ids

    jcache = JT.make_paged_cache(jcfg, SLOTS, MAX_LEN, block_k=BLOCK_K)
    tcache = TT.make_paged_cache(tcfg, SLOTS, MAX_LEN, block_k=BLOCK_K,
                                 device="cpu")
    jlogits, tlogits = [], []
    for slot in range(SLOTS):
        calibrate = slot == 0                      # first admission calibrates
        jstep = jax.jit(jsteps.make_paged_prefill_step(jcfg,
                                                       calibrate=calibrate))
        jl, jcache = jstep(jparams, jnp.asarray(prompts[slot:slot + 1]),
                           jcache, jnp.asarray([slot], jnp.int32),
                           jnp.asarray(rows[slot:slot + 1]))
        tl, tcache = TT.prefill_paged(
            tparams, torch.from_numpy(prompts[slot:slot + 1]), tcfg, tcache,
            torch.tensor([slot], dtype=torch.int32),
            torch.from_numpy(rows[slot:slot + 1]), calibrate=calibrate)
        jlogits.append(np.asarray(jl))
        tlogits.append(tl.numpy())
    jdecode = jax.jit(jsteps.make_decode_step(jcfg))
    for t in range(STEPS):
        jl, jcache = jdecode(jparams, jnp.asarray(steps_tok[t]), jcache)
        tl, tcache = TT.decode_step(tparams, torch.from_numpy(steps_tok[t]),
                                    tcfg, tcache)
        jlogits.append(np.asarray(jl))
        tlogits.append(tl.numpy())

    jall, tall = np.concatenate(jlogits), np.concatenate(tlogits)
    assert tall.shape == jall.shape == (SLOTS * (1 + STEPS), 512)
    assert np.isfinite(tall).all()
    np.testing.assert_allclose(tall, jall, rtol=0,
                               atol=1e-3 * np.abs(jall).max())

    jkv = jcache["kv"]
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jkv["length"]))
    np.testing.assert_array_equal(tcache["block_table"].numpy(),
                                  np.asarray(jkv["block_table"]))
    np.testing.assert_allclose(tcache["scale_k"].numpy(),
                               np.asarray(jkv["scale_k"]), rtol=1e-6)
    for name in ("k_pages", "v_pages"):
        diff = np.abs(tcache[name].numpy().astype(np.int32)
                      - np.asarray(jkv[name]).astype(np.int32))
        assert diff.max() <= 1, name
        assert (diff != 0).mean() < 1e-3, name
