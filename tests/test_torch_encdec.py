"""The encoder-decoder model of the PyTorch port against the JAX reference
(``repro.models.encdec``) on SeamlessM4T-medium's smoke config in float32
(as ``serve.py --smoke`` runs it), and its building blocks: the parametric
LayerNorm, the GELU MLP, the attention modes with ``causal=False`` and
``kv_valid_len``, and the encoder-decoder bridge.

Parameters come from ``repro.launch.steps.init_params_fn`` with
``PRNGKey(4)`` (the reference's ``tests/test_engines.py`` rig) and cross
through ``repro_torch.bridge``; frames and tokens are numpy draws.
Tolerances, and why:

* float outputs (encoder memory, logits) within 1e-3 of their largest
  magnitude, the tolerance of ``tests/test_torch_model.py``: the two
  frameworks' f32 matmuls, LayerNorm and RoPE differ in the last bits,
  which can move an int8 value on a rounding edge by one step;
* the training-mode (fakequant and float) encoder, the training loss and
  its gradients within 1e-5 of the largest magnitude (no int8 rounding);
* the int8 self and cross pages equal bit for bit; the four pool scales
  within 1e-6 relative (each is an f32 absmax over a layer's K or V, whose
  last bits the frameworks' f32 arithmetic moves; 1e-6 is two ulps);
* LayerNorm: f32 within 1e-4 of the output's magnitude (a row of mean
  1000 and unit spread loses ~4 digits to the f32 rounding of its mean, in
  either framework's summation order), bf16 within one bf16 step (2^-8);
  the GELU MLP and the activation: f32 within 2e-6, bf16 within 2^-7 of
  the MLP's magnitude and 2^-6 absolute for the activation (JAX rounds each
  intermediate of a bf16 GELU to bf16, torch only the result).  Each is tighter than what a biased variance (~0.8%) or the
  erf GELU (up to ~5e-4 absolute) would give, which the tests check.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch as jget_arch
from repro.core import attention as jattn
from repro.launch import steps as jsteps
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import mlp as JM
from repro_torch import bridge
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import attention as tattn
from repro_torch.kernels import splitmax_attn
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TE
from repro_torch.models import frontend
from repro_torch.models import layers as TL
from repro_torch.models import mlp as TM

torch.set_num_threads(1)

ARCH = "seamless_m4t_medium"
SLOTS, PROMPT, ENC, STEPS, BLOCK_K = 2, 12, 12, 6, 8
MAX_LEN = 30


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    jcfg = jget_arch(ARCH).smoke.replace(dtype="float32")
    tcfg = tget_arch(ARCH).smoke.replace(dtype="float32")
    jparams = jax.device_get(jsteps.init_params_fn(jcfg)(
        jax.random.PRNGKey(4)))
    tparams = bridge.from_jax_params(jparams, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _frames(rng, b, s, d):
    return np.asarray(rng.normal(size=(b, s, d)), np.float32) * 0.02


# ------------------------------------------------------------- layers ------

def _norm_rows(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    x[1] *= 40.0
    x[3] += 1000.0                     # a large mean over a unit spread
    return x, jnp.asarray(x, dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    _, jx, tx = _norm_rows(dtype)
    rng = np.random.default_rng(6)
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    want = np.asarray(JL.layernorm_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jx), np.float32)
    got = TL.layernorm_apply({k: _t(v) for k, v in p.items()}, tx)
    assert got.dtype == tx.dtype
    got = got.to(torch.float32).numpy()
    rel = 1e-4 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(
        want).max())
    # the unbiased variance would miss by far more than the tolerance
    xf = tx.to(torch.float32)
    biased = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        torch.var(xf, -1, keepdim=True) + 1e-5) * _t(p["scale"]) + _t(p["bias"])
    assert np.abs(biased.numpy() - want).max() > rel * np.abs(want).max()
    assert TL.NORM_INIT["layernorm"](64, "cpu")["bias"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(models, dtype):
    jcfg, jparams, tcfg, tparams = models
    jcfg, tcfg = (c.replace(dtype=dtype) for c in (jcfg, tcfg))
    x, jx, tx = _norm_rows(dtype)
    jx, tx = jx[:, :] * 0.05, tx * 0.05
    lp = jax.tree.map(lambda a: a[0], jparams["decoder"])["mlp"]
    assert set(lp) == {"w_in", "w_out"}           # no gate: act="gelu"
    want = np.asarray(JM.mlp_apply(lp, jx, jcfg), np.float32)
    got = TM.mlp_apply(tparams["decoder"][0]["mlp"], tx, tcfg)
    assert got.dtype == getattr(torch, dtype)
    rel = 2e-6 if dtype == "float32" else 2 ** -7
    _close(got.to(torch.float32).numpy(), want, rel)
    # the activation alone, over its curved range and a large-mean row
    h = np.concatenate([np.linspace(-6, 6, 241, dtype=np.float32),
                        x[3, :16]])
    want = np.asarray(jax.nn.gelu(jnp.asarray(h, dtype)), np.float32)
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    got = F.gelu(th, approximate="tanh").to(torch.float32).numpy()
    erf = F.gelu(th.to(torch.float32)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
        assert np.abs(erf - want).max() > 1e-4
    else:
        # JAX rounds each intermediate of its bf16 GELU to bf16, torch
        # computes in f32 and rounds once
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=2 ** -6)


# ---------------------------------------------------------- attention ------

@pytest.mark.parametrize("mode", ["float", "fakequant", "int8"])
@pytest.mark.parametrize("shape", [(12, 12, True), (12, 12, False),
                                   (12, 20, False)])
def test_attention_causal_flag_matches_reference(mode, shape):
    """``AttentionSpec.causal`` in every mode: the decoder's causal self
    attention, the encoder's bidirectional one and the cross attention over
    a longer memory (Sq 12 x Sk 20), against ``repro.core.attention``."""
    sq, sk, causal = shape
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 4, s, 16)).astype(np.float32)
               for s in (sq, sk, sk))
    jspec = jattn.AttentionSpec(mode=mode, causal=causal)
    tspec = tattn.AttentionSpec(mode=mode, causal=causal)
    want = np.asarray(jattn.attention(*map(jnp.asarray, (q, k, v)), jspec))
    got = tattn.attention(_t(q), _t(k), _t(v), tspec).numpy()
    _close(got, want, 1e-5)
    if not causal and mode != "float":
        # keys past kv_valid_len: the reference's fakequant and int8 modes
        want = np.asarray(jattn.attention(*map(jnp.asarray, (q, k, v)), jspec,
                                          kv_valid_len=jnp.int32(9)))
        got = tattn.attention(_t(q), _t(k), _t(v), tspec, kv_valid_len=9)
        _close(got.numpy(), want, 1e-5)
    if mode == "float" and not causal:
        # the port's float mode honours kv_valid_len too (the reference's
        # drops it): equal to truncating the keys
        got = tattn.attention(_t(q), _t(k), _t(v), tspec, kv_valid_len=9)
        cut = tattn.attention(_t(q), _t(k[:, :, :9]), _t(v[:, :, :9]), tspec)
        torch.testing.assert_close(got, cut, rtol=0, atol=1e-6)


def test_encoder_and_cross_kernel_shapes_plain_exact_and_default():
    """Kernel 1's plain version at the encoder's (bidirectional, 12 x 12)
    and the cross attention's (12 x 20) shapes: ``exact=True`` (the CUDA
    kernel's bits) within the reference kernel tests' 2e-5 of the default,
    whose f32 sums equal JAX's ``xla`` path within the same."""
    from repro.core.lut import LUTConfig as JLUT
    from repro.kernels import ops as jops
    from repro_torch.core import lut as tlut
    from repro_torch.kernels import ops as tops
    cfg = tlut.LUTConfig(scale_z=8.0 / 127)
    exp_lut, recip_lut = tattn.luts_for(cfg.scale_z, torch.device("cpu"))
    rng = np.random.default_rng(8)
    for sq, sk in ((12, 12), (12, 20)):
        q = rng.integers(-128, 128, (1, 4, sq, 16)).astype(np.int8)
        k, v = (rng.integers(-128, 128, (1, 4, sk, 16)).astype(np.int8)
                for _ in range(2))
        scales = (np.float32(0.01), np.float32(0.012), np.float32(0.02))
        m_z = tops.requant_multiplier(torch.tensor(scales[0]),
                                      torch.tensor(scales[1]), 16, cfg)
        args = (_t(q), _t(k), _t(v), m_z.reshape(()), torch.tensor(scales[2]),
                exp_lut, recip_lut)
        default = splitmax_attn.splitmax_attention_plain(*args, cfg=cfg,
                                                         causal=False)
        exact = splitmax_attn.splitmax_attention_plain(*args, cfg=cfg,
                                                       causal=False,
                                                       exact=True)
        want = jops.splitmax_attention(
            *map(jnp.asarray, (q, k, v)), *(jnp.float32(s) for s in scales),
            jnp.asarray(exp_lut.numpy()), jnp.asarray(recip_lut.numpy()),
            cfg=JLUT(scale_z=cfg.scale_z), causal=False, impl="xla")
        np.testing.assert_allclose(default.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(exact.numpy(), default.numpy(),
                                   rtol=2e-5, atol=2e-5)


# -------------------------------------------------------------- model ------

def test_bridge_round_trip(models):
    jcfg, jparams, tcfg, tparams = models
    assert len(tparams["encoder"]) == tcfg.n_encoder_layers == 2
    assert len(tparams["decoder"]) == tcfg.n_layers == 2
    layer = tparams["decoder"][1]
    assert set(layer) == {"norm1", "self_attn", "norm2", "cross_attn",
                          "norm3", "mlp"}
    assert set(layer["norm3"]) == {"scale", "bias"}
    back = bridge.to_jax_layout(tparams)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    with pytest.raises(ValueError, match="stacked decoder"):
        bridge.from_jax_params(jparams, tcfg.replace(n_layers=3),
                               device="cpu")


def test_init_shapes_and_serving_init(models):
    """The port's own init has the reference's tree and shapes; its
    leaf-by-leaf serving init equals casting the f32 masters (the table,
    the f32 head, and the norms stay f32)."""
    jcfg, jparams, tcfg, _ = models
    mine = bridge.to_jax_layout(TE.init_params(tcfg, seed=1, device="cpu"))
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(jparams))
    jax.tree.map(lambda a, b: np.testing.assert_equal(a.shape, b.shape),
                 mine, jparams)
    cfg = tcfg.replace(dtype="bfloat16")
    want = TE.cast_for_serving(TE.init_params(cfg, seed=3, device="cpu"), cfg)
    got = TE.init_params(cfg, seed=3, device="cpu", serving=True)
    for a, b in zip(bridge.tu.leaves(want), bridge.tu.leaves(got),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["embed"]["table"].dtype == torch.float32
    assert got["decoder"][0]["cross_attn"]["wq"]["w"].dtype == torch.bfloat16
    assert got["encoder"][0]["norm1"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("serve", [False, True])
def test_encode_and_decode_sequence_match_reference(models, serve):
    """Both branches: training (fakequant attention) and serving (int8:
    kernel 1 bidirectional in the encoder, causal in the decoder, and
    non-causal over S_enc keys in the cross attention).  The decoder runs
    on the reference's memory, so each stage is held on its own."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    frames = _frames(rng, 2, ENC + 4, jcfg.d_model)
    tokens = rng.integers(0, jcfg.vocab_size, (2, PROMPT), dtype=np.int32)
    jmem = np.asarray(JE.encode(jparams, jnp.asarray(frames), jcfg,
                                serve=serve))
    tmem = TE.encode(tparams, _t(frames), tcfg, serve=serve)
    assert tmem.shape == (2, ENC + 4, tcfg.d_model)
    _close(tmem.detach().numpy(), jmem, 1e-3 if serve else 1e-5)
    jl, jys = JE.decode_sequence(jparams, jnp.asarray(tokens),
                                 jnp.asarray(jmem), jcfg, serve=serve)
    tl, tys = TE.decode_sequence(tparams, _t(tokens), _t(jmem), tcfg,
                                 serve=serve)
    assert tl.shape == (2, PROMPT, 512) and tl.dtype == torch.float32
    _close(tl.detach().numpy(), jl, 1e-3 if serve else 1e-5)
    if serve:
        for name in ("self_kv", "cross_kv"):
            for i in range(tcfg.n_layers):
                for got, want in zip(tys[name][i], jys[name]):
                    _close(got.numpy(), np.asarray(want)[i], 1e-5)


def test_cross_kv_computed_once_equals_computed_twice(models):
    """The port projects the cross K/V once a layer for both the cross
    attention and the cache (the reference twice): the once-computed pair
    equals a fresh projection, and the attention over it equals the one
    that projects its own, bit for bit."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(3)
    memory = _t(_frames(rng, 1, ENC, tcfg.d_model) * 50)
    tokens = _t(rng.integers(0, tcfg.vocab_size, (1, PROMPT)))
    _, ys = TE.decode_sequence(tparams, tokens, memory, tcfg, serve=True)
    spec = tcfg.attn_spec(serve=True)
    for i, lp in enumerate(tparams["decoder"]):
        again = TA.cross_kv(lp["cross_attn"], memory, tcfg)
        for a, b in zip(ys["cross_kv"][i], again):
            assert torch.equal(a, b)
        x = _t(rng.normal(size=(1, PROMPT, tcfg.d_model)).astype(np.float32))
        assert torch.equal(
            TA.cross_attn_apply(lp["cross_attn"], x, memory, tcfg, spec=spec,
                                kv=again),
            TA.cross_attn_apply(lp["cross_attn"], x, memory, tcfg, spec=spec))


def test_training_loss_and_grads_match_reference(models):
    """``steps.loss_fn`` on an encdec batch (float attention, remat):
    the loss and every gradient within 1e-5 of JAX's."""
    jcfg, jparams, tcfg, _ = models
    jcfg, tcfg = (c.replace(attn_mode="float") for c in (jcfg, tcfg))
    # value_and_grad sets requires_grad on every leaf: its own copy
    tparams = bridge.from_jax_params(jparams, tcfg, device="cpu")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 13), dtype=np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "frames": _frames(rng, 2, ENC, jcfg.d_model)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, b, jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    (tloss, metrics), tgrads = tsteps.value_and_grad(
        tparams, {k: _t(v) for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(metrics["aux_loss"]) == float(metrics["z_loss"]) == 0.0
    back = bridge.to_jax_layout(tgrads)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jgrads))
    jax.tree.map(lambda g, w: _close(g, w, 1e-5), back, jgrads)


def _paged_pair(jcfg, tcfg):
    bps = -(-MAX_LEN // BLOCK_K)
    cbps = -(-ENC // BLOCK_K)
    cross = np.arange(1, 1 + SLOTS * cbps, dtype=np.int32).reshape(SLOTS, cbps)
    nb = 1 + SLOTS * (bps + cbps)
    rows = np.arange(1 + SLOTS * cbps, nb, dtype=np.int32).reshape(SLOTS, bps)
    rows = rows[:, ::-1].copy()                    # non-monotone block ids
    kw = dict(block_k=BLOCK_K, num_blocks=nb, cross_table=cross, enc_len=ENC)
    return (rows, JE.make_paged_cache(jcfg, SLOTS, MAX_LEN, **kw),
            TE.make_paged_cache(tcfg, SLOTS, MAX_LEN, device="cpu", **kw))


def _assert_pools_equal(jcache, tcache):
    jkv, tkv = jcache["kv"], tcache["kv"]
    for name in ("k_pages", "v_pages", "block_table", "length"):
        np.testing.assert_array_equal(tkv[name].numpy(), np.asarray(jkv[name]),
                                      err_msg=name)
    for got, want in ((tkv["scale_k"], jkv["scale_k"]),
                      (tkv["scale_v"], jkv["scale_v"]),
                      (tcache["cross_scale_k"], jcache["cross_scale_k"]),
                      (tcache["cross_scale_v"], jcache["cross_scale_v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for name in ("cross_table", "cross_len", "length"):
        np.testing.assert_array_equal(tcache[name].numpy(),
                                      np.asarray(jcache[name]), err_msg=name)


def test_paged_prefill_and_decode_match_reference(models):
    """Two admissions (the first calibrates all four scales, the second
    quantizes into them), then decode steps: the int8 self pages and the
    carved cross pages bit for bit after each, the logits within 1e-3."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(9)
    rows, jcache, tcache = _paged_pair(jcfg, tcfg)
    frames = _frames(rng, SLOTS, ENC, jcfg.d_model)
    prompts = rng.integers(0, jcfg.vocab_size, (SLOTS, PROMPT), dtype=np.int32)
    jall, tall = [], []
    for slot in range(SLOTS):
        step = jax.jit(jsteps.make_paged_prefill_step(jcfg,
                                                      calibrate=slot == 0))
        tstep = tsteps.make_paged_prefill_step(tcfg, calibrate=slot == 0)
        args = (frames[slot:slot + 1], prompts[slot:slot + 1])
        jl, jcache = step(jparams, *map(jnp.asarray, args), jcache,
                          jnp.asarray([slot], jnp.int32),
                          jnp.asarray(rows[slot:slot + 1]))
        tl, tcache = tstep(tparams, *map(_t, args), tcache,
                           torch.tensor([slot], dtype=torch.int32),
                           _t(rows[slot:slot + 1]))
        _assert_pools_equal(jcache, tcache)
        jall.append(np.asarray(jl))
        tall.append(tl.numpy())
    assert np.abs(tcache["kv"]["k_pages"][:, 1:1 + SLOTS * 2].numpy()).max() > 0
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    tdec = tsteps.make_decode_step(tcfg)
    for _ in range(STEPS):
        tok = rng.integers(0, jcfg.vocab_size, SLOTS, dtype=np.int32)
        jl, jcache = jdec(jparams, jnp.asarray(tok), jcache)
        tl, tcache = tdec(tparams, _t(tok), tcache)
        jall.append(np.asarray(jl))
        tall.append(tl.numpy())
    _assert_pools_equal(jcache, tcache)
    jall, tall = np.concatenate(jall), np.concatenate(tall)
    assert tall.shape == (SLOTS * (1 + STEPS), 512) and np.isfinite(tall).all()
    _close(tall, jall, 1e-3)
    assert tcache["length"].tolist() == [PROMPT + STEPS] * SLOTS


def test_dense_cache_prefill_and_decode_match_reference(models):
    """The dense-cache path at ``tests/test_arch_smoke.py``'s shapes (B 2,
    a 16-token prompt, max_len 48, 12 frames): the decode kernels 4 and 6
    (``attn_fused`` on and off) for self and cross attention."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(10)
    b, s, max_len = 2, 16, 48
    frames = _frames(rng, b, ENC, jcfg.d_model)
    tokens = rng.integers(0, jcfg.vocab_size, (b, s), dtype=np.int32)
    jcache = JE.make_cache(jcfg, b, max_len, enc_len=ENC)
    jlast, jcache = JE.prefill(jparams, jnp.asarray(frames),
                               jnp.asarray(tokens), jcfg, jcache)
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    jlog, jcache = JE.decode_step(jparams, jnp.asarray(nxt), jcfg, jcache)
    for fused in (True, False):
        cfg = tcfg.replace(attn_fused=fused)
        step = tsteps.make_prefill_step(cfg, max_len)
        tlast, tcache = step(tparams, {"tokens": _t(tokens),
                                       "frames": _t(frames)})
        _close(tlast.numpy(), jlast, 1e-3)
        tlog, tcache = tsteps.make_decode_step(cfg)(tparams, _t(nxt), tcache)
        assert tlog.shape == (b, 512) and torch.isfinite(tlog).all()
        _close(tlog.numpy(), jlog, 1e-3)
        assert tcache["length"].tolist() == [s + 1] * b
        assert tcache["self_kv"]["length"].tolist() == [s + 1] * b
        for name in ("cross_k_q", "cross_v_q"):
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jcache[name]))
        np.testing.assert_array_equal(tcache["self_kv"]["k_q"].numpy(),
                                      np.asarray(jcache["self_kv"]["k_q"]))


def test_frontend_stubs():
    gen = torch.Generator().manual_seed(0)
    f = frontend.audio_frame_embeddings(gen, 2, 7, 64)
    assert f.shape == (2, 7, 64) and f.dtype == torch.float32
    assert 0.01 < float(f.std()) < 0.03
    ids = frontend.vq_image_tokens(torch.Generator().manual_seed(0), 3, 50,
                                   65536)
    assert ids.dtype == torch.int32 and ids.shape == (3, 50)
    assert int(ids.min()) >= 8192 and int(ids.max()) < 65536
    again = frontend.audio_frame_embeddings(torch.Generator().manual_seed(0),
                                            2, 7, 64)
    assert torch.equal(f, again)


def test_spec_causal_default_and_replace():
    spec = tget_arch(ARCH).smoke.attn_spec(serve=True)
    assert spec.causal and spec.mode == "int8"
    assert not dataclasses.replace(spec, causal=False).causal
