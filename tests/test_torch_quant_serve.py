"""Int8-resident serve weights: the port against the JAX reference.

``quantize_weights_for_serving`` turns every linear ``{"w"}`` and table
``{"table"}`` of two or more dims into an int8 payload and its f32 scale
(``w_q``/``w_s``, ``table_q``/``table_s``).  The absmax of an f32 leaf,
``/ 127`` and ``round(w / s)`` are exact or IEEE in both packages, so the
port's leaves equal the reference's bit for bit, per family, and bridge
both ways (a per-layer scale is the reference's stacked scale at that
layer).  A serving init with ``serve_param_dtype="int8"`` equals
quantizing the f32 masters after the init.  Layers dequantize at use,
``f32(w_q) * w_s`` cast to the compute dtype, as the reference's
``w_q.astype(bf16) * w_s`` promotes to f32 with its (1, 1) f32 scale.

Served from the reference's quantized smoke parameters (f32 compute,
bridged), the port's greedy tokens equal ``repro.launch.serve``'s: the
dense decoder plain, self-drafted and composed, the MoE and
encoder-decoder families, and the hybrid through the dense cache.
Mamba-1 layers with int8 weights fail in the reference with a
``KeyError: 'w'`` (its step reads ``dt_proj``'s float ``w``); the port
refuses them with a ``ValueError`` before anything runs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.quantization import quantize_weights_for_serving as jquant
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch import tree as tu
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core.quantization import (
    quantize_weights_for_serving as tquant)
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

FAMILIES = ["tinyllama_1p1b", "deepseek_moe_16b", "seamless_m4t_medium",
            "falcon_mamba_7b", "zamba2_2p7b"]
KW = dict(slots=3, gen=16, block_k=8)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's f32 smoke parameters and their int8 serve weights
    (numpy leaves), and both configs."""
    jcfg = jget_arch(arch).smoke.replace(dtype="float32")
    tcfg = tget_arch(arch).smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(0))
    return (jcfg, tcfg, jax.device_get(jparams),
            jax.device_get(jquant(jparams)))


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_torch_trees_equal(got, want):
    got, want = (dict((tu.keystr(p), v) for p, v in tu.leaves_with_path(t))
                 for t in (got, want))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype and torch.equal(got[key], w), key


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        assert got[key].shape == w.shape, key
        assert np.array_equal(got[key], w), key


@pytest.mark.parametrize("arch", FAMILIES)
def test_quantize_weights_for_serving_bitwise(arch):
    jcfg, tcfg, jparams, jq = _reference(arch)
    tparams = bridge.from_jax_params(jparams, tcfg, device="cpu")
    got = tquant(tparams)
    n_int8 = sum(v.dtype == torch.int8 for v in jax.tree.leaves(got))
    assert n_int8 > 0
    for path, leaf in _leaves(bridge.to_jax_layout(got, tcfg)).items():
        if path.endswith("_s']"):
            assert leaf.dtype == np.float32 and leaf.shape[-2:] == (1, 1)
    _assert_trees_equal(bridge.to_jax_layout(got, tcfg), jq)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bridge_of_quantized_params_round_trips(arch):
    _, tcfg, _, jq = _reference(arch)
    tq = bridge.from_jax_params(jq, tcfg, device="cpu")
    first = tq["encoder"][0] if "encoder" in tq else tq["layers"][0]
    leaves = _leaves(first)
    assert any(k.endswith("['w_q']") for k in leaves)
    assert all(v.shape == (1, 1) for k, v in leaves.items()
               if k.endswith("['w_s']"))
    _assert_trees_equal(bridge.to_jax_layout(tq, tcfg), jq)


def _init(cfg, **kw):
    fn = TE.init_params if cfg.family == "encdec" else TT.init_params
    return fn(cfg, seed=3, device="cpu", **kw)


def _cast(params, cfg):
    fn = TE.cast_for_serving if cfg.family == "encdec" else \
        TT.cast_for_serving
    return fn(params, cfg)


@pytest.mark.parametrize("arch", [a for a in FAMILIES
                                  if a != "falcon_mamba_7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_init_int8_equals_quantize_after_init(arch, dtype):
    """Quantizing each layer's f32 draw at once == quantizing (and, for
    the float leaves a step casts, casting) the f32 masters afterwards."""
    cfg = tget_arch(arch).smoke.replace(dtype=dtype,
                                        serve_param_dtype="int8")
    masters = _init(cfg)
    got = _init(cfg, serving=True)
    _assert_torch_trees_equal(got, _cast(masters, cfg))
    if cfg.family in ("dense", "encdec"):     # every weight is a linear/table
        _assert_torch_trees_equal(got, tquant(masters))
    # int8 leaves kept as they are by a second cast
    again = _cast(got, cfg)
    assert all(a is b for a, b in zip(jax.tree.leaves(again),
                                      jax.tree.leaves(got))
               if a.dtype == torch.int8)


def test_int8_forward_tracks_float():
    """The reference's fidelity check (``tests/test_quantization.py``): on
    OLMo-1B's smoke config (its tied table quantized too), the forward
    through int8 weights stays within a total variation of 0.05 of the
    float one."""
    jcfg, tcfg, jparams, jq = _reference("olmo_1b")
    tparams = bridge.from_jax_params(jparams, tcfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 16)))
    with torch.no_grad():
        lg_f, _ = TT.forward(tparams, tok, tcfg)
        lg_q, _ = TT.forward(tquant(tparams), tok, tcfg)
    pf, pq = (torch.softmax(lg[..., :tcfg.vocab_size], -1)
              for lg in (lg_f, lg_q))
    tv = 0.5 * float(torch.mean(torch.sum(torch.abs(pf - pq), -1)))
    assert 0 < tv < 0.05, tv


def test_serving_init_int8_moe_router_quantized_stacks_float():
    cfg = tget_arch("deepseek_moe_16b").smoke.replace(
        dtype="bfloat16", serve_param_dtype="int8")
    moe = next(lp["moe"] for lp in _init(cfg, serving=True)["layers"]
               if "moe" in lp)
    assert moe["router"]["w_q"].dtype == torch.int8
    assert moe["shared"]["w_in"]["w_q"].dtype == torch.int8
    assert all(moe[k].dtype == torch.bfloat16
               for k in ("w_in", "w_gate", "w_out"))


def test_dequant_promotion_matches_reference(rng):
    """bf16 dequant: the reference's ``w_q.astype(bf16) * w_s`` computes in
    f32 (its scale is an f32 array) and rounds once; the port's
    ``linear_weight`` gives the same bits, and a product with the scale in
    bf16 does not (the check has teeth)."""
    w = rng.normal(0, 0.05, (384, 320)).astype(np.float32)
    jw = jquant({"p": {"w": jnp.asarray(w)}})["p"]
    tw = tquant({"p": {"w": torch.from_numpy(w)}})["p"]
    assert tuple(tw["w_s"].shape) == (1, 1)
    x = rng.normal(0, 1, (5, 384)).astype(np.float32)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32,
                                                     jnp.float32)):
        got = TL.linear_weight(tw, dt)
        want = (jw["w_q"].astype(jdt) * jw["w_s"]).astype(jdt)
        assert got.dtype == dt
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))
        y = TL.linear_apply(tw, torch.from_numpy(x), dtype=dt)
        jy = JL.linear_apply(jw, jnp.asarray(x), dtype=jdt)
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(jy.astype(jnp.float32)),
                                   rtol=2e-2 if dt == torch.bfloat16 else
                                   1e-5, atol=1e-5)
    naive = tw["w_q"].to(torch.bfloat16) * tw["w_s"].to(torch.bfloat16)
    assert not torch.equal(naive, TL.linear_weight(tw, torch.bfloat16))


def test_int8_embedding_and_tied_head_match_reference(rng):
    table = rng.normal(0, 0.02, (64, 32)).astype(np.float32)
    jt = jquant({"table": jnp.asarray(table)})
    tt = tquant({"table": torch.from_numpy(table)})
    ids = rng.integers(0, 64, (2, 7))
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32,
                                                     jnp.float32)):
        got = TL.embedding_apply(tt, torch.from_numpy(ids), dtype=dt)
        want = JL.embedding_apply(jt, jnp.asarray(ids), dtype=jdt)
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))
    x = rng.normal(0, 1, (2, 3, 32)).astype(np.float32)
    got = TL.unembed_apply(tt, torch.from_numpy(x))
    want = JL.unembed_apply(jt, jnp.asarray(x), logical_vocab=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_logits_dtype_sets_the_head_dtype():
    cfg = tget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    params = _init(cfg)
    x = torch.randn((2, 3, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    f32 = TT.unembed(params, x, cfg)
    bf16 = TT.unembed(params, x, cfg.replace(logits_dtype="bfloat16"))
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16.float(), f32, rtol=2e-2, atol=2e-2)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The distance in bf16 ulps between two bf16 tensors (their bit
    patterns mapped onto one ordered integer line)."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("weights", ["float32", "int8"])
@pytest.mark.parametrize("arch", ["tinyllama_1p1b", "olmo_1b"])
def test_bf16_head_matches_reference(arch, weights):
    """``logits_dtype="bfloat16"``: the port's head (untied on TinyLlama's
    smoke config, through ``linear_apply``; tied on OLMo's, through
    ``unembed_apply``) against ``repro.models.transformer.unembed`` on the
    same bridged weights and inputs, f32 and int8.  The two frameworks
    may sum a bf16 dot's products in different orders, so a logit may be
    1 bf16 ulp off; at most 1 in 1000 are (0 of 5120 measured with int8
    weights, 1 with OLMo's f32 table).  A head that rounds the int8 scale
    product in bf16, or scales the table before the cast, moves ~40% of
    them, by up to thousands of ulps."""
    jcfg, tcfg, jparams, jq = _reference(arch)
    jcfg, tcfg = (c.replace(logits_dtype="bfloat16") for c in (jcfg, tcfg))
    jp = jq if weights == "int8" else jparams
    tp = bridge.from_jax_params(jp, tcfg, device="cpu")
    head = tp["embed"] if tcfg.tie_embeddings else tp["lm_head"]
    assert ("table_q" in head or "w_q" in head) == (weights == "int8")
    x = np.random.default_rng(0).normal(0, 1, (2, 5, jcfg.d_model)).astype(
        np.float32)
    got = TT.unembed(tp, torch.from_numpy(x), tcfg)
    want = torch.from_numpy(np.array(
        JT.unembed(jp, jnp.asarray(x), jcfg).astype(jnp.float32))).to(
        torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    ulps = _bf16_ulps(got, want)
    assert int(ulps.max()) <= 1, int(ulps.max())
    assert int((ulps > 0).sum()) <= ulps.numel() // 1000


def _churn(jcfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, jcfg.vocab_size, 24, dtype=np.int32)
               for _ in range(n)]
    gens = [int(g) for g in rng.integers(8, 17, n)]
    return rng, prompts, gens


@pytest.mark.parametrize("mode", ["plain", "self-drafted", "composed"])
def test_dense_serve_tokens_equal_reference(mode):
    jcfg, tcfg, _, jq = _reference("tinyllama_1p1b")
    tq = bridge.from_jax_params(jq, tcfg, device="cpu")
    _, prompts, gens = _churn(jcfg)
    kw = dict(KW, gens=gens)
    if mode == "self-drafted":
        kw.update(draft="self", gamma=4)
    if mode == "composed":
        jcfg, tcfg = (c.replace(attn_fused=False) for c in (jcfg, tcfg))
    want = jserve.serve(jq, jcfg, prompts, **kw)
    got = tserve.serve(tq, tcfg, prompts, **kw)
    assert got["finished"] == want["finished"]
    assert got["leaked_blocks"] == want["leaked_blocks"] == 0


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "seamless_m4t_medium",
                                  "zamba2_2p7b"])
def test_family_serve_tokens_equal_reference(arch):
    jcfg, tcfg, _, jq = _reference(arch)
    tq = bridge.from_jax_params(jq, tcfg, device="cpu")
    rng, prompts, gens = _churn(jcfg)
    kw = dict(KW, gens=gens)
    if jcfg.family == "encdec":
        kw["frames"] = [np.asarray(rng.normal(size=(24, jcfg.d_model)),
                                   np.float32) * 0.02 for _ in prompts]
    if jcfg.family == "hybrid":
        kw["cache_kind"] = "dense"
        want = jserve.serve_dense(jq, jcfg, prompts, slots=KW["slots"],
                                  gen=KW["gen"], gens=gens)
    else:
        want = jserve.serve(jq, jcfg, prompts, **kw)
    got = tserve.serve(tq, tcfg, prompts, **kw)
    assert got["finished"] == want["finished"]


def test_int8_config_quantizes_f32_masters_when_served():
    """``serve_param_dtype="int8"`` on f32 masters: the engine quantizes
    them, and the tokens are those of the reference's quantized weights."""
    jcfg, tcfg, jparams, jq = _reference("tinyllama_1p1b")
    masters = bridge.from_jax_params(jparams, tcfg, device="cpu")
    _, prompts, gens = _churn(jcfg, seed=1)
    want = jserve.serve(jq, jcfg, prompts, gens=gens, **KW)
    got = tserve.serve(masters, tcfg.replace(serve_param_dtype="int8"),
                       prompts, gens=gens, **KW)
    assert got["finished"] == want["finished"]


def test_falcon_mamba_int8_refused_where_the_reference_fails():
    jcfg, tcfg, _, jq = _reference("falcon_mamba_7b")
    prompts = [np.arange(8, dtype=np.int32)]
    with pytest.raises(KeyError, match="'w'"):
        jserve.serve(jq, jcfg, prompts, slots=1, gen=2)
    tq = bridge.from_jax_params(jq, tcfg, device="cpu")
    for cache_kind in ("paged", "dense"):
        with pytest.raises(ValueError, match="ssm family"):
            tserve.serve(tq, tcfg, prompts, slots=1, gen=2,
                         cache_kind=cache_kind)
    with pytest.raises(ValueError, match="ssm family"):
        TT.init_params(tcfg.replace(serve_param_dtype="int8"), device="cpu",
                       serving=True)
