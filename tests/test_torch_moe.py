"""The MoE family of the PyTorch port against ``repro.models.moe`` and
``repro.models.transformer`` on the DeepSeekMoE-16B and Mixtral-8x22B smoke
configs in float32 (as ``serve.py --smoke`` runs them).

Parameters come from ``repro.launch.steps.init_params_fn`` and cross
through ``repro_torch.bridge``; inputs are ``np.random.default_rng`` draws.

Tolerances, and why:

* routing indices, queue positions and the dropped set are integers and
  equal exactly, except for a token whose k-th and (k+1)-th router
  probabilities lie within ``TIE`` (1e-6) of each other: the two packages'
  f32 router GEMM and softmax differ in the last bits (~1e-8 here), which
  can swap such a pair.  Such tokens are counted, must be rare, and their
  whole group (the queue positions cascade) is left out of the comparison;
* the layer's output within 1e-5 of its largest magnitude: f32 sums of
  products taken in another order (the combine sums each token's k rows
  instead of contracting the one-hot), ~1e-7 relative here;
* ``aux_loss`` and ``z_loss`` within 1e-5 relative: f32 means over B * S;
* model logits within 1e-3 of their largest magnitude, the tolerance of
  ``tests/test_torch_model.py``: a last-bit difference can move an int8
  K/V value on a rounding edge by one step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch import bridge, trace
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_arch as tget_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import mlp as TMLP
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

MOE_ARCHS = ["deepseek_moe_16b", "mixtral_8x22b"]
TIE = 1e-6
SLOTS, PROMPT, STEPS, BLOCK_K, GAMMA = 2, 20, 16, 8, 4
MAX_LEN = PROMPT + STEPS + GAMMA + 8


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=MOE_ARCHS)
def models(request):
    jcfg = jget_arch(request.param).smoke.replace(dtype="float32")
    tcfg = tget_arch(request.param).smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(0))
    tparams = bridge.from_jax_params(jax.device_get(jparams), tcfg,
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


def _jax_routing(jlayer, x, jcfg):
    """The reference's routing, its own lines (``repro/models/moe.py``):
    f32 router, softmax, top-k, renormalised; queue positions."""
    mc = jcfg.moe
    logits = JL.linear_apply(jlayer["router"], jnp.asarray(x, jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, mc.top_k)
    onehot = jax.nn.one_hot(gate_idx, mc.n_experts, dtype=jnp.int32)
    b, s = x.shape[:2]
    flat = onehot.reshape(b, s * mc.top_k, mc.n_experts)
    pos_flat = jnp.cumsum(flat, axis=1) - flat
    pos_k = jnp.sum(pos_flat.reshape(b, s, mc.top_k, mc.n_experts) * onehot,
                    axis=-1)
    top = jax.lax.top_k(probs, mc.top_k + 1)[0]     # top_k < n_experts
    return (np.asarray(probs), np.asarray(gate_idx), np.asarray(pos_k),
            np.asarray(top))


@pytest.mark.parametrize("s", [8, 64], ids=["overflow", "long"])
def test_moe_apply_matches_reference(models, s):
    jcfg, jparams, tcfg, tparams = models
    mc = jcfg.moe
    fd = mc.first_dense_layers
    jlayer = jax.tree.map(lambda a: a[0], jparams["segments"][-1]["moe"])
    tlayer = tparams["layers"][fd]["moe"]
    x = np.random.default_rng(s).normal(size=(4, s, jcfg.d_model)
                                        ).astype(np.float32)
    jprobs, jidx, jpos, jtop = _jax_routing(jlayer, x, jcfg)
    cap = JMOE._capacity(mc, s)
    assert TMOE._capacity(tcfg.moe, s) == cap

    _, tprobs, _, tidx = TMOE.route(tlayer, _t(x), tcfg)
    np.testing.assert_allclose(tprobs.numpy(), jprobs, rtol=0, atol=1e-6)
    # near-ties of the k-th and (k+1)-th probability may swap
    tie = jtop[..., -2] - jtop[..., -1] <= TIE
    assert tie.sum() <= 0.01 * tie.size, tie.sum()
    ok = ~tie
    np.testing.assert_array_equal(tidx.numpy()[ok], jidx[ok])
    # positions: the port's cumsum of the reference's indices, exactly
    np.testing.assert_array_equal(
        TMOE.queue_positions(_t(jidx).long(), mc.n_experts).numpy(), jpos)
    groups = ~tie.any(axis=1)
    tpos = TMOE.queue_positions(tidx, mc.n_experts).numpy()
    np.testing.assert_array_equal(tpos[groups], jpos[groups])
    dropped = jpos >= cap
    np.testing.assert_array_equal((tpos >= cap)[groups], dropped[groups])
    if s == 8:
        assert dropped.any()                 # tokens overflow capacity

    jout, jaux = JMOE.moe_apply(jlayer, jnp.asarray(x), jcfg)
    tout, taux = TMOE.moe_apply(tlayer, _t(x), tcfg)
    jout = np.asarray(jout)
    assert tout.dtype == torch.float32 and tout.shape == jout.shape
    np.testing.assert_allclose(tout.numpy()[groups], jout[groups], rtol=0,
                               atol=1e-5 * np.abs(jout).max())
    for name in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-5)
    # the serve path: no losses, the same output, routed per token too
    for tokenwise in (False, True):
        out, aux = TMOE.moe_apply(tlayer, _t(x), tcfg, losses=False,
                                  tokenwise=tokenwise)
        assert aux == {}
        assert torch.equal(out, tout)


def test_routing_record_equals_route_and_reference(models):
    """With the recorder on, ``moe_apply`` keeps each call's top-k expert
    ids and the margin of the k-th over the (k+1)-th router logit, tagged
    with the ``model.layer`` span open: the ids equal ``route()``'s, and
    the reference's on the bridged parameters (near-ties left out as
    above); a tie goes to the lower expert in both packages.  A serve
    forward tags one record a MoE layer with its index."""
    jcfg, jparams, tcfg, tparams = models
    mc = jcfg.moe
    fd = mc.first_dense_layers
    jlayer = jax.tree.map(lambda a: a[0], jparams["segments"][-1]["moe"])
    tlayer = tparams["layers"][fd]["moe"]
    x = np.random.default_rng(5).normal(size=(3, 16, jcfg.d_model)
                                        ).astype(np.float32)
    zero = dict(tlayer, router=jax.tree.map(torch.zeros_like,
                                            tlayer["router"]))
    jzero = dict(jlayer, router=jax.tree.map(jnp.zeros_like,
                                             jlayer["router"]))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 12)))
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        with trace.span("model.layer", i=fd):
            TMOE.moe_apply(tlayer, _t(x), tcfg, losses=False)
            TMOE.moe_apply(zero, _t(x), tcfg, losses=False)
        got, tied = trace.drain()["routes"]
        TT.forward(tparams, tokens, tcfg, serve=True)
        served = trace.drain()["routes"]
    finally:
        trace.disable()
    assert got["layer"] == tied["layer"] == fd
    assert torch.equal(got["idx"], TMOE.route(tlayer, _t(x), tcfg)[3])
    _, jidx, _, jtop = _jax_routing(jlayer, x, jcfg)
    ok = ~(jtop[..., -2] - jtop[..., -1] <= TIE)
    np.testing.assert_array_equal(got["idx"].numpy()[ok], jidx[ok])
    jlogits = np.asarray(JL.linear_apply(jlayer["router"], jnp.asarray(x)))
    top = -np.sort(-jlogits, axis=-1)
    margin = top[..., mc.top_k - 1] - top[..., mc.top_k]
    np.testing.assert_allclose(got["margin"].numpy()[ok], margin[ok], rtol=0,
                               atol=1e-5)
    lower = np.broadcast_to(np.arange(mc.top_k), jidx.shape)
    np.testing.assert_array_equal(tied["idx"].numpy(), lower)
    np.testing.assert_array_equal(_jax_routing(jzero, x, jcfg)[1], lower)
    assert torch.equal(tied["margin"], torch.zeros(x.shape[:2]))
    assert [r["layer"] for r in served] == \
        [i for i, lp in enumerate(tparams["layers"]) if "moe" in lp]
    assert all(r["idx"].shape == (2, 12, mc.top_k) for r in served)


def test_dropped_tokens_fall_through_the_residual(models):
    """A dropped assignment adds nothing: with every assignment past a
    capacity of ``top_k`` slots, a group of ``S > 1`` identical tokens
    gives its later tokens the shared experts' output only."""
    jcfg, _, tcfg, tparams = models
    mc = tcfg.moe
    fd = mc.first_dense_layers
    tlayer = tparams["layers"][fd]["moe"]
    row = np.random.default_rng(1).normal(size=(1, 1, tcfg.d_model))
    x = _t(np.repeat(row, 4, axis=1).astype(np.float32))
    cap = TMOE._capacity(mc, 4)
    _, _, _, idx = TMOE.route(tlayer, x, tcfg)
    pos = TMOE.queue_positions(idx, mc.n_experts)
    assert pos[0, :, 0].tolist() == list(range(4))   # one queue per expert
    out, _ = TMOE.moe_apply(tlayer, x, tcfg)
    shared = (TMLP.mlp_apply(tlayer["shared"], x, tcfg) if mc.n_shared
              else torch.zeros_like(x))
    for t in range(4):
        if t >= cap:
            assert torch.equal(out[0, t], shared[0, t])
        else:
            assert not torch.equal(out[0, t], shared[0, t])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_reference(arch):
    jcfg, tcfg = jget_arch(arch).config, tget_arch(arch).config
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    if arch == "deepseek_moe_16b":
        assert tcfg.param_count() == 16_375_728_128


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    """Every field the port's config has, and the smoke twin's, equal the
    reference's, letter for letter, for every config of the port's
    registry; the source tags too."""
    for which in ("config", "smoke"):
        jcfg = getattr(jget_arch(arch), which)
        tcfg = getattr(tget_arch(arch), which)
        for f in tcfg.__dataclass_fields__:
            want = getattr(jcfg, f)
            got = getattr(tcfg, f)
            if f in ("moe", "ssm") and want is not None:
                want, got = vars(want), vars(got)
            assert got == want, (which, f)
    assert tget_arch(arch).source == jget_arch(arch).source


def test_bridge_round_trip_with_two_segments():
    jcfg = jget_arch("deepseek_moe_16b").smoke.replace(dtype="float32")
    tcfg = tget_arch("deepseek_moe_16b").smoke.replace(dtype="float32")
    jparams = jax.device_get(jsteps.init_params_fn(jcfg)(
        jax.random.PRNGKey(2)))
    assert len(jparams["segments"]) == 2           # 1 dense, then 2 MoE
    tparams = bridge.from_jax_params(jparams, tcfg, device="cpu")
    assert ["moe" in lp for lp in tparams["layers"]] == [False, True, True]
    back = bridge.to_jax_layout(tparams)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    with pytest.raises(ValueError, match="segment"):
        bridge.from_jax_params(dict(jparams, segments=jparams["segments"][::-1]),
                               tcfg, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS + ["tinyllama_1p1b"])
def test_serving_init_equals_cast_masters(arch):
    cfg = tget_arch(arch).smoke.replace(dtype="bfloat16")
    want = TT.cast_for_serving(TT.init_params(cfg, seed=3, device="cpu"), cfg)
    got = TT.init_params(cfg, seed=3, device="cpu", serving=True)
    flat_g = []

    def walk(a, b, path):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b, strict=True)):
                walk(x, y, path + (i,))
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path
            flat_g.append((path, b.dtype))

    walk(want, got, ())
    dtypes = dict(flat_g)
    assert dtypes[("lm_head", "w")] == torch.float32
    assert dtypes[("embed", "table")] == torch.bfloat16
    if cfg.family == "moe":
        lp = len(got["layers"]) - 1
        assert dtypes[("layers", lp, "moe", "router", "w")] == torch.float32
        for name in ("w_in", "w_gate", "w_out"):
            assert dtypes[("layers", lp, "moe", name)] == torch.bfloat16
        # cast_for_serving keeps a leaf already in the compute dtype
        again = TT.cast_for_serving(got, cfg)
        assert again["layers"][lp]["moe"]["w_in"] is \
            got["layers"][lp]["moe"]["w_in"]


def test_forward_logits_and_aux_match_reference(models):
    jcfg, jparams, tcfg, tparams = models
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 24),
                                               dtype=np.int32)
    jl, _ = jax.jit(lambda p, t: JT.forward(p, t, jcfg, serve=True))(
        jparams, jnp.asarray(tokens))
    tl, _ = TT.forward(tparams, _t(tokens), tcfg, serve=True)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=1e-3 * np.abs(jl).max())
    # training mode in float attention: logits and the summed MoE losses
    jf, tf = jcfg.replace(attn_mode="float"), tcfg.replace(attn_mode="float")
    jl, jaux = jax.jit(lambda p, t: JT.forward(p, t, jf))(
        jparams, jnp.asarray(tokens))
    tl, taux = TT.forward(tparams, _t(tokens), tf)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=0,
                               atol=1e-5 * np.abs(jl).max())
    for name in ("aux_loss", "z_loss"):
        assert float(jaux[name]) > 0
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-5)


def _prefilled(models, seed):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, jcfg.vocab_size, (SLOTS, PROMPT), dtype=np.int32)
    bps = -(-MAX_LEN // BLOCK_K)
    rows = np.arange(1, 1 + SLOTS * bps, dtype=np.int32).reshape(SLOTS, bps)
    rows = rows[:, ::-1].copy()                    # non-monotone block ids
    jcache = JT.make_paged_cache(jcfg, SLOTS, MAX_LEN, block_k=BLOCK_K)
    tcache = TT.make_paged_cache(tcfg, SLOTS, MAX_LEN, block_k=BLOCK_K,
                                 device="cpu")
    jlast, tlast = [], []
    for slot in range(SLOTS):
        step = jax.jit(jsteps.make_paged_prefill_step(jcfg,
                                                      calibrate=slot == 0))
        jl, jcache = step(jparams, jnp.asarray(prompts[slot:slot + 1]), jcache,
                          jnp.asarray([slot], jnp.int32),
                          jnp.asarray(rows[slot:slot + 1]))
        tl, tcache = TT.prefill_paged(
            tparams, _t(prompts[slot:slot + 1]), tcfg, tcache,
            torch.tensor([slot], dtype=torch.int32), _t(rows[slot:slot + 1]),
            calibrate=slot == 0)
        jlast.append(np.asarray(jl))
        tlast.append(tl.numpy())
    return jcache, tcache, np.concatenate(jlast), np.concatenate(tlast), rng


def test_prefill_paged_and_decode_match_reference(models):
    jcfg, jparams, tcfg, tparams = models
    jcache, tcache, jl, tl, rng = _prefilled(models, 3)
    jall, tall = [jl], [tl]
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    for _ in range(STEPS):
        tok = rng.integers(0, jcfg.vocab_size, SLOTS, dtype=np.int32)
        jl, jcache = jdec(jparams, jnp.asarray(tok), jcache)
        tl, tcache = TT.decode_step(tparams, _t(tok), tcfg, tcache)
        jall.append(np.asarray(jl))
        tall.append(tl.numpy())
    jall, tall = np.stack(jall), np.stack(tall)
    np.testing.assert_allclose(tall, jall, rtol=0,
                               atol=1e-3 * np.abs(jall).max())
    assert tcache["length"].tolist() == [PROMPT + STEPS] * SLOTS


def test_verify_step_equals_decode_and_reference(models):
    """The verify step routes its T tokens as one capacity group, the
    decode step each token alone.  With T <= top_k every expert's capacity
    (at least top_k) holds all T assignments it can get, nothing is dropped,
    and verify's logits and cache are the decode steps' bit for bit.  With
    T = 4 the smoke configs' capacities (3 and 2) can drop assignments that
    decode keeps, in the reference too (ROADMAP queue 3), so there only the
    comparison with the reference holds."""
    jcfg, jparams, tcfg, tparams = models
    jcache, tcache, _, _, rng = _prefilled(models, 4)
    tokens = rng.integers(0, jcfg.vocab_size, (SLOTS, GAMMA), dtype=np.int32)
    k = tcfg.moe.top_k
    assert TMOE._capacity(tcfg.moe, k) >= k
    ver_cache = {n: v.clone() for n, v in tcache.items()}
    seq_cache = {n: v.clone() for n, v in tcache.items()}
    logits, ver_cache = TT.verify_step(tparams, _t(tokens[:, :k]), tcfg,
                                       ver_cache)
    for t in range(k):
        step_logits, seq_cache = TT.decode_step(tparams, _t(tokens[:, t]),
                                                tcfg, seq_cache)
        assert torch.equal(logits[:, t], step_logits), t
    for name in ("k_pages", "v_pages", "length"):
        assert torch.equal(ver_cache[name], seq_cache[name]), name

    logits, tcache = TT.verify_step(tparams, _t(tokens), tcfg, tcache)
    jlogits, jcache = jax.jit(jsteps.make_verify_step(jcfg))(
        jparams, jnp.asarray(tokens), jcache)
    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                               atol=1e-3 * np.abs(jlogits).max())


def test_other_families_and_moe_training_are_refused(models):
    """Since the SSM slice the SSM family initialises (a config without its
    SSMConfig does not); a hybrid still has no cache engine.  Training a
    MoE, refused until the slice that trains every family, now runs
    (``tests/test_torch_train_families.py`` holds it against JAX)."""
    _, _, tcfg, tparams = models
    ssm = tget_arch("falcon_mamba_7b").smoke
    assert all("ssm" in lp for lp in
               TT.init_params(ssm, device="cpu")["layers"])
    with pytest.raises(ValueError, match="SSMConfig"):
        TT.init_params(tcfg.replace(family="ssm"), device="cpu")
    with pytest.raises(ValueError, match="no cache engine"):
        tserve.make_engine(tparams, tcfg.replace(family="hybrid"),
                           [np.zeros(4, np.int32)], slots=1, max_len=16)
    rec = ttrain.main(["--arch", "deepseek_moe_16b", "--smoke", "--device",
                       "cpu", "--steps", "1", "--batch", "2", "--seq", "8"])
    assert np.isfinite(rec["losses"]).all() and rec["cfg"].family == "moe"
    with pytest.raises(ValueError, match="dense model"):
        tserve.make_self_draft(tparams, tcfg, 1)
