"""The SSM and hybrid models of the PyTorch port against the JAX reference
(``repro.models.ssm`` and the SSM and hybrid halves of
``repro.models.transformer``) on Falcon-Mamba-7B's and Zamba2-2.7B's smoke
configs in float32 (as ``serve.py --smoke`` runs them).

Parameters come from ``repro.launch.steps.init_params_fn`` with
``PRNGKey(3)`` and cross through ``repro_torch.bridge``; inputs are
``np.random.default_rng`` draws.  Tolerances, and why:

* ``_causal_conv1d`` and ``_associative_scan`` equal the reference bit for
  bit when JAX runs them op by op (the port writes out
  ``jax.lax.associative_scan``'s odd/even recursion, so its f32 products
  and sums are combined in JAX's order); compiled, XLA contracts the
  combine's ``a * b + c`` into a fused multiply-add, which moves the last
  bit, so the chunked scans (a ``lax.scan`` body, compiled) are held within
  1e-6 of their largest magnitude (~8 f32 ulps);
* ``_segsum`` within 1e-6 of its largest magnitude (the frameworks'
  cumulative sums add in different orders); the SSD (matmuls whose f32
  sums the frameworks order differently), the blocks and the logits
  within 1e-5 of the largest magnitude; the decode states within 1e-5
  too;
* the hybrid's int8 K/V equal bit for bit; its per-layer scales within
  1e-6 relative (an f32 absmax over projections whose last bits the
  frameworks' f32 sums move);
* the port's own identities (naive recurrences, chunk invariance, decode
  against the full forward, the conv carry): the reference's
  ``tests/test_ssm.py`` tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig, SSMConfig

torch.set_num_threads(1)

ARCHS = ("falcon_mamba_7b", "zamba2_2p7b")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg = jget_arch(arch).smoke.replace(dtype="float32")
    tcfg = tget_arch(arch).smoke.replace(dtype="float32")
    jparams = jax.device_get(jsteps.init_params_fn(jcfg)(
        jax.random.PRNGKey(3)))
    tparams = bridge.from_jax_params(jparams, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, b=2, s=13, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ------------------------------------------------- the scans against JAX --

def test_causal_conv1d_equals_reference(rng):
    x = rng.normal(size=(2, 12, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    tail = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for t in (None, tail):
        jy, jt = JS._causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   None if t is None else jnp.asarray(t))
        ty, tt = TS._causal_conv1d(_t(x), _t(w), None if t is None else _t(t))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_associative_scan_is_jax_recursion(rng):
    """Bit for bit ``jax.lax.associative_scan`` run op by op, at every
    length up to 40 (odd and even at each recursion level); values stay
    clear of f32 denormals, which XLA's CPU flushes to zero."""
    def combine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    for n in range(1, 41):
        a = (np.exp(rng.normal(-1, 0.3, (2, n, 3))) * 0.9).astype(np.float32)
        b = rng.normal(size=(2, n, 3)).astype(np.float32)
        ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                    jnp.asarray(b)), axis=1)
        ta, tb = TS._associative_scan(_t(a), _t(b))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), str(n))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb), str(n))


@pytest.mark.parametrize("s,chunk", [(32, 8), (13, 8), (7, 16), (37, 16)])
def test_mamba1_scan_chunked_matches_reference(rng, s, chunk):
    b, d, n = 2, 8, 4
    a = (np.exp(rng.normal(-1, 0.3, (b, s, d, n))) * 0.9).astype(np.float32)
    bx = rng.normal(size=(b, s, d, n)).astype(np.float32)
    h0 = rng.normal(size=(b, d, n)).astype(np.float32)
    jh, jl = JS._mamba1_scan_chunked(jnp.asarray(a), jnp.asarray(bx),
                                     jnp.asarray(h0), chunk)
    th, tl = TS._mamba1_scan_chunked(_t(a), _t(bx), _t(h0), chunk)
    assert th.shape == (b, s, d, n)
    _close(th, jh, 1e-6)
    _close(tl, jl, 1e-6)


@pytest.mark.parametrize("s,chunk", [(16, 4), (21, 8), (5, 8)])
def test_ssd_chunked_matches_reference(rng, s, chunk):
    b, h, p, n = 2, 3, 4, 8
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    log_a = -np.abs(rng.normal(0.5, 0.3, (b, s, h))).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (b, h, n, p)).astype(np.float32)
    jy, jl = JS._ssd_chunked(*map(jnp.asarray, (xh, log_a, bm, cm, h0)),
                             chunk)
    ty, tl = TS._ssd_chunked(*map(_t, (xh, log_a, bm, cm, h0)), chunk)
    _close(ty, jy, 1e-5)
    _close(tl, jl, 1e-5)


def test_segsum_matches_reference(rng):
    la = -np.abs(rng.normal(size=(2, 3, 9))).astype(np.float32)
    want = np.asarray(JS._segsum(jnp.asarray(la)))
    got = TS._segsum(_t(la)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], 1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_blocks_match_reference(models, with_state):
    """``mamba1_apply``/``mamba2_apply`` on layer 0's bridged weights, from
    no state (training) and from a random carried state (decode)."""
    jcfg, jparams, tcfg, tparams = models
    apply_j = JS.mamba1_apply if jcfg.ssm.kind == "mamba1" else \
        JS.mamba2_apply
    jlayer = (jax.tree.map(lambda a: a[0], jparams["segments"][0]["ssm"])
              if "segments" in jparams else
              jax.tree.map(lambda a: a[0, 0], jparams["mamba_groups"]["ssm"]))
    tlayer = tparams["layers"][0]["ssm"]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, tcfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        shapes = TS.state_shapes(tcfg, 2)
        state = {k: rng.normal(size=v).astype(np.float32)
                 for k, v in shapes.items()}
    jy, jst = apply_j(jlayer, jnp.asarray(x), jcfg, state=None if state is
                      None else {k: jnp.asarray(v) for k, v in state.items()})
    ty, tst = TS.MAMBA_APPLY[tcfg.ssm.kind](
        tlayer, _t(x), tcfg,
        state=None if state is None else {k: _t(v) for k, v in
                                          state.items()})
    _close(ty, jy, 1e-5)
    assert (tst is None) == (jst is None)
    if with_state:
        for k in ("conv", "h"):
            _close(tst[k], jst[k], 1e-5)


# ----------------------------------- the reference's tests/test_ssm.py --

def _cfg(kind, chunk):
    return ModelConfig(
        name="t", family="ssm", n_layers=1, d_model=32, n_heads=1,
        n_kv_heads=1, d_ff=0, vocab_size=64,
        ssm=SSMConfig(kind=kind, d_state=8, headdim=16, chunk=chunk))


def test_mamba1_chunked_scan_matches_naive(rng):
    b, s, d, n = 2, 32, 8, 4
    a = (np.exp(rng.normal(-1, 0.3, (b, s, d, n))) * 0.9).astype(np.float32)
    bx = rng.normal(0, 1, (b, s, d, n)).astype(np.float32)
    h0 = rng.normal(0, 1, (b, d, n)).astype(np.float32)
    h_all, h_last = TS._mamba1_scan_chunked(_t(a), _t(bx), _t(h0), chunk=8)
    h = h0.copy()
    want = np.zeros((b, s, d, n), np.float32)
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        want[:, t] = h
    np.testing.assert_allclose(h_all.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), want[:, -1], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mamba1_chunk_size_invariance(rng, chunk):
    b, s, d, n = 1, 16, 4, 4
    a = (np.exp(rng.normal(-1, 0.3, (b, s, d, n))) * 0.9).astype(np.float32)
    bx = rng.normal(0, 1, (b, s, d, n)).astype(np.float32)
    h0 = np.zeros((b, d, n), np.float32)
    ref, _ = TS._mamba1_scan_chunked(_t(a), _t(bx), _t(h0), chunk=16)
    got, _ = TS._mamba1_scan_chunked(_t(a), _t(bx), _t(h0), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_ssd_chunked_matches_naive(rng):
    b, s, h, p, n = 1, 16, 2, 4, 8
    xh = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    log_a = -np.abs(rng.normal(0.5, 0.3, (b, s, h))).astype(np.float32)
    bmat = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    cmat = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (b, h, n, p)).astype(np.float32)
    y, h_last = TS._ssd_chunked(*map(_t, (xh, log_a, bmat, cmat, h0)),
                                chunk=4)
    state = h0.copy()
    want = np.zeros((b, s, h, p), np.float32)
    for t in range(s):
        decay = np.exp(log_a[:, t])
        state = (state * decay[:, :, None, None]
                 + np.einsum("bn,bhp->bhnp", bmat[:, t], xh[:, t]))
        want[:, t] = np.einsum("bn,bhnp->bhp", cmat[:, t], state)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(h_last.numpy(), state, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_block_decode_matches_full_forward(rng, kind):
    """s+1 tokens at once against an s-token pass and one stateful step."""
    cfg = _cfg(kind, chunk=4)
    gen = torch.Generator().manual_seed(0)
    params = TS.MAMBA_INIT[kind](gen, cfg, device="cpu")
    apply = TS.MAMBA_APPLY[kind]
    b, s = 1, 8
    x = _t(rng.normal(0, 1, (b, s + 1, cfg.d_model)).astype(np.float32))
    full, _ = apply(params, x, cfg, state=None)
    _, st = apply(params, x[:, :s], cfg,
                  state=TS.zero_state(cfg, b, device="cpu"))
    inc, _ = apply(params, x[:, s:], cfg, state=st)
    np.testing.assert_allclose(inc[:, 0].numpy(), full[:, s].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_causal_conv_state_carry(rng):
    b, s, c, k = 2, 12, 6, 4
    x = _t(rng.normal(0, 1, (b, s, c)).astype(np.float32))
    w = _t(rng.normal(0, 1, (k, c)).astype(np.float32))
    full, _ = TS._causal_conv1d(x, w, None)
    y1, tail = TS._causal_conv1d(x[:, :8], w, torch.zeros((b, k - 1, c)))
    y2, _ = TS._causal_conv1d(x[:, 8:], w, tail)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------- the whole models --

@pytest.mark.parametrize("serve", [False, True])
def test_forward_matches_reference(models, serve):
    """Training mode (fakequant attention in the hybrid) and serve mode
    (int8; the stacked states after the sequence from zeros)."""
    jcfg, jparams, tcfg, tparams = models
    tok = _tokens(tcfg)
    jlogits, jaux = jax.jit(lambda p, t: JT.forward(p, t, jcfg, serve=serve))(
        jparams, jnp.asarray(tok))
    tlogits, taux = TT.forward(tparams, _t(tok), tcfg, serve=serve)
    _close(tlogits, jlogits, 1e-5)
    if serve:
        for k in ("conv", "h"):
            assert taux["ssm"][k].shape == jaux["ssm"][k].shape
            _close(taux["ssm"][k], jaux["ssm"][k], 1e-5)
        if tcfg.family == "hybrid":
            jk, jv = jaux["kv"]
            assert len(taux["kv"]) == jk.shape[0] == 2
            for g, (k, v) in enumerate(taux["kv"]):
                _close(k, jk[g], 1e-5)
                _close(v, jv[g], 1e-5)
        else:
            assert "kv" not in taux


def test_prefill_and_decode_on_the_dense_cache(models):
    """The dense cache after a ragged prefill and 4 greedy decode steps:
    logits and the float states within tolerance, the hybrid's int8 K/V
    bit for bit and its scales within 1e-6."""
    jcfg, jparams, tcfg, tparams = models
    tok = _tokens(tcfg)
    lens = np.array([13, 9], np.int32)
    jcache = JT.make_cache(jcfg, 2, 24)
    jlast, jcache = jax.jit(lambda p, t, c, v: JT.prefill(
        p, t, jcfg, c, valid_len=v))(jparams, jnp.asarray(tok), jcache,
                                     jnp.asarray(lens))
    tcache = TT.make_cache(tcfg, 2, 24, device="cpu")
    tlast, tcache = TT.prefill(tparams, _t(tok), tcfg, tcache,
                               valid_len=_t(lens))
    _close(tlast, jlast, 1e-5)
    step = jax.jit(lambda p, t, c: JT.decode_step(p, t, jcfg, c))
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for _ in range(4):
        jlogits, jcache = step(jparams, jnp.asarray(nxt), jcache)
        tlogits, tcache = TT.decode_step(tparams, _t(nxt), tcfg, tcache)
        _close(tlogits, jlogits, 1e-5)
        nxt = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["length"]))
    for k in ("conv", "h"):
        _close(tcache[k], jcache["ssm"][k], 1e-5)
    if tcfg.family == "hybrid":
        jkv = jcache["kv"]
        assert tcache["k_q"].shape[0] == tcfg.n_layers // \
            tcfg.hybrid_attn_every
        for name in ("k_q", "v_q"):
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jkv[name]))
        for name in ("scale_k", "scale_v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jkv[name]), rtol=1e-6)
    else:
        assert set(tcache) == {"conv", "h", "length"}


# ---------------------------------------------- params, configs, bridge --

@pytest.mark.parametrize("arch,want", [("falcon_mamba_7b", 7_272_140_800),
                                       ("zamba2_2p7b", 2_360_130_208)])
def test_count_params_equal_reference(arch, want):
    """Analytic, from the configs alone: nothing is allocated."""
    tcfg, jcfg = tget_arch(arch).config, jget_arch(arch).config
    assert tcfg.param_count() == jcfg.param_count() == want
    smoke = tget_arch(arch).smoke
    n = sum(x.numel() for _, x in _leaves(TT.init_params(smoke,
                                                          device="cpu")))
    # the formulas count the embedding at the logical vocab (the smoke
    # vocab 512 is already a multiple of 256: no padding)
    assert n == smoke.param_count()


def _leaves(tree, path=""):
    """(path, leaf) pairs in path order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, list):
        items = list(enumerate(tree))
    else:
        return [(path, tree)]
    return [x for k, v in items for x in _leaves(v, f"{path}/{k}")]


def test_bridge_round_trip(models):
    jcfg, jparams, tcfg, tparams = models
    assert len(tparams["layers"]) == tcfg.n_layers
    assert all(set(lp) == {"norm1", "ssm"} for lp in tparams["layers"])
    back = bridge.to_jax_layout(tparams, tcfg)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    if tcfg.family == "hybrid":
        with pytest.raises(ValueError, match="config"):
            bridge.to_jax_layout(tparams)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_init_and_cast_keep_the_f32_leaves(arch):
    """``init_params(serving=True)`` equals ``cast_for_serving`` of the f32
    draw bit for bit; the projections and ``conv_w`` are bf16, and
    Mamba-1's ``dt_proj`` (multiplied by the f32 ``dt_in``), ``A_log``,
    ``D``, ``dt_bias`` and the norms stay f32."""
    cfg = tget_arch(arch).smoke.replace(dtype="bfloat16")
    f32 = TT.init_params(cfg, seed=5, device="cpu")
    cast = TT.cast_for_serving(f32, cfg)
    served = TT.init_params(cfg, seed=5, device="cpu", serving=True)
    assert [p for p, _ in _leaves(cast)] == [p for p, _ in _leaves(served)]
    for (path, a), (_, b) in zip(_leaves(cast), _leaves(served)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    ssm = served["layers"][0]["ssm"]
    for name in ("in_proj", "out_proj") + (("x_proj",) if "x_proj" in ssm
                                           else ()):
        assert ssm[name]["w"].dtype == torch.bfloat16
    assert ssm["conv_w"].dtype == torch.bfloat16
    f32_names = (("dt_proj", "A_log", "D") if cfg.ssm.kind == "mamba1"
                 else ("A_log", "D", "dt_bias", "norm"))
    for name in f32_names:
        for _, leaf in _leaves(ssm[name]):
            assert leaf.dtype == torch.float32, name
    if cfg.ssm.kind == "mamba1":
        # kept, not copied
        assert (cast["layers"][0]["ssm"]["dt_proj"]["w"]
                is f32["layers"][0]["ssm"]["dt_proj"]["w"])
    else:
        sp = served["shared_attn"]
        assert sp["attn"]["wq"]["w"].shape == (2 * cfg.d_model,
                                               cfg.n_heads * cfg.hd)
        assert sp["attn"]["wo"]["w"].shape == (cfg.n_heads * cfg.hd,
                                               cfg.d_model)
        assert sp["norm"]["scale"].shape == (2 * cfg.d_model,)
        assert sp["attn"]["wq"]["w"].dtype == torch.bfloat16

