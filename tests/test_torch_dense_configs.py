"""The rest of the dense family in the PyTorch port against the JAX
reference: OLMo-1B (non-parametric LayerNorm, tied head), Mistral-NeMo-12B
(GQA, 32 heads of 128 under d_model 5120 at full width), Chameleon-34B
(per-head q/k RMSNorm, tied by the default), DeepSeek-Coder-33B (GQA group
7 at full width) and DeepSeek-67B, each at its smoke size in float32 (as
``serve.py --smoke`` runs them).

Parameters come from ``repro.launch.steps.init_params_fn`` and cross
through ``repro_torch.bridge``; inputs are ``np.random.default_rng``
draws.  Tolerances, and why:

* paged prefill and decode logits within 1e-3 of their largest magnitude,
  the tolerance of ``tests/test_torch_model.py``: the two frameworks' f32
  matmuls, norms and RoPE differ in the last bits, which can move an int8
  K/V value on a rounding edge by one step;
* served greedy tokens equal exactly;
* the training loss and every gradient within 1e-5 of the reference's
  largest magnitude (float attention: f32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import config as jconfig
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch import tree as tu
from repro_torch.configs import get_arch as tget_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import config as tconfig
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

DENSE_ARCHS = ["olmo_1b", "mistral_nemo_12b", "chameleon_34b",
               "deepseek_coder_33b", "deepseek_67b"]
SLOTS, PROMPT, STEPS, BLOCK_K, GAMMA = 2, 12, 6, 8, 4
MAX_LEN = PROMPT + STEPS + GAMMA + 8


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def models(request):
    jcfg = jget_arch(request.param).smoke.replace(dtype="float32")
    tcfg = tget_arch(request.param).smoke.replace(dtype="float32")
    jparams = jax.device_get(jsteps.init_params_fn(jcfg)(
        jax.random.PRNGKey(0)))
    tparams = bridge.from_jax_params(jparams, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_tie_embeddings_default_equals_reference():
    """The reference ties by default; configs that do not state the field
    (Chameleon-34B, its smoke twin, OLMo's smoke twin) come out tied, with
    no ``lm_head`` leaf."""
    default = {f.name: f.default for f in dataclasses.fields(
        tconfig.ModelConfig)}["tie_embeddings"]
    want = {f.name: f.default for f in dataclasses.fields(
        jconfig.ModelConfig)}["tie_embeddings"]
    assert default is want is True
    arch = tget_arch("chameleon_34b")
    assert arch.config.tie_embeddings and arch.smoke.tie_embeddings
    assert tget_arch("olmo_1b").smoke.tie_embeddings
    params = TT.init_params(arch.smoke, device="cpu")
    assert "lm_head" not in params
    for name in ("tinyllama_1p1b", "deepseek_moe_16b", "mixtral_8x22b",
                 "mistral_nemo_12b", "deepseek_coder_33b", "deepseek_67b"):
        assert not tget_arch(name).config.tie_embeddings, name
        assert not tget_arch(name).smoke.tie_embeddings, name


def test_unported_norm_and_act_raise():
    """The parametric LayerNorm and the GELU MLP are ported (the
    encoder-decoder config uses them); a norm or an activation that neither
    package has raises at construction."""
    cfg = tget_arch("olmo_1b").smoke
    assert cfg.replace(norm="layernorm", act="gelu").act == "gelu"
    for kw in (dict(norm="batchnorm"), dict(act="relu")):
        with pytest.raises(ValueError, match="not in"):
            cfg.replace(**kw)


def test_bridge_round_trip(models):
    jcfg, jparams, tcfg, tparams = models
    assert len(tparams["layers"]) == tcfg.n_layers
    assert ("lm_head" in tparams) == (not tcfg.tie_embeddings)
    layer = tparams["layers"][0]
    if tcfg.norm == "nonparam_ln":
        assert layer["norm1"] == layer["norm2"] == tparams["final_norm"] == {}
    assert ("q_norm" in layer["attn"]) == tcfg.qk_norm
    back = bridge.to_jax_layout(tparams)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    with pytest.raises(ValueError, match="lm_head"):
        bridge.from_jax_params(jparams, tcfg.replace(
            tie_embeddings=not tcfg.tie_embeddings), device="cpu")


def test_serving_init_equals_cast_masters(models):
    """Leaf-by-leaf serving init equals casting the f32 masters; a tied
    table stays f32 (it is the f32 LM head too)."""
    _, _, tcfg, _ = models
    cfg = tcfg.replace(dtype="bfloat16")
    want = TT.cast_for_serving(TT.init_params(cfg, seed=3, device="cpu"), cfg)
    got = TT.init_params(cfg, seed=3, device="cpu", serving=True)
    pairs = list(zip(tu.leaves_with_path(want), tu.leaves_with_path(got),
                     strict=True))
    for (pa, a), (pb, b) in pairs:
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
    table = got["embed"]["table"].dtype
    assert table == (torch.float32 if cfg.tie_embeddings else torch.bfloat16)


def test_paged_prefill_and_decode_match_reference(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, jcfg.vocab_size, (SLOTS, PROMPT), dtype=np.int32)
    bps = -(-MAX_LEN // BLOCK_K)
    rows = np.arange(1, 1 + SLOTS * bps, dtype=np.int32).reshape(SLOTS, bps)
    rows = rows[:, ::-1].copy()                    # non-monotone block ids
    jcache = JT.make_paged_cache(jcfg, SLOTS, MAX_LEN, block_k=BLOCK_K)
    tcache = TT.make_paged_cache(tcfg, SLOTS, MAX_LEN, block_k=BLOCK_K,
                                 device="cpu")
    jall, tall = [], []
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
        jall.append(np.asarray(jl))
        tall.append(tl.numpy())
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    for _ in range(STEPS):
        tok = rng.integers(0, jcfg.vocab_size, SLOTS, dtype=np.int32)
        jl, jcache = jdec(jparams, jnp.asarray(tok), jcache)
        tl, tcache = TT.decode_step(tparams, _t(tok), tcfg, tcache)
        jall.append(np.asarray(jl))
        tall.append(tl.numpy())
    jall, tall = np.concatenate(jall), np.concatenate(tall)
    assert tall.shape == jall.shape == (SLOTS * (1 + STEPS), 512)
    assert np.isfinite(tall).all()
    np.testing.assert_allclose(tall, jall, rtol=0,
                               atol=1e-3 * np.abs(jall).max())
    assert tcache["length"].tolist() == [PROMPT + STEPS] * SLOTS


def test_paged_churn_tokens_equal_reference(models):
    """A small churn (requests > slots, staggered lengths, prompts that
    straddle blocks): greedy tokens, steps and admissions equal, no leak."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, 12, dtype=np.int32)
               for _ in range(4)]
    gens = [int(g) for g in rng.integers(4, 9, 4)]
    kw = dict(slots=2, gen=8, gens=gens, block_k=8)
    want = jserve.serve(jparams, jcfg, prompts, **kw)
    got = tserve.serve(tparams, tcfg, prompts, **kw)
    assert got["finished"] == want["finished"]
    assert got["served"] == want["served"] == len(prompts)
    for key in ("decode_steps", "slot_prefills", "total_tokens"):
        assert got[key] == want[key], key
    assert got["leaked_blocks"] == 0


def test_verify_step_equals_decode_step_with_qk_norm():
    """Chameleon's q/k norms in the verify step run at the decode step's
    shape: its logits and cache equal T sequential decode steps' bit for
    bit.  (The reference's verify equals its decode steps too, so the
    comparison with JAX is the decode test's above.)"""
    jcfg = jget_arch("chameleon_34b").smoke.replace(dtype="float32")
    tcfg = tget_arch("chameleon_34b").smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(1))
    tparams = bridge.from_jax_params(jax.device_get(jparams), tcfg,
                                     device="cpu")
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, jcfg.vocab_size, (SLOTS, PROMPT), dtype=np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (SLOTS, GAMMA), dtype=np.int32)
    bps = -(-MAX_LEN // BLOCK_K)
    rows = np.arange(1, 1 + SLOTS * bps, dtype=np.int32).reshape(SLOTS, bps)
    tcache = TT.make_paged_cache(tcfg, SLOTS, MAX_LEN, block_k=BLOCK_K,
                                 device="cpu")
    for slot in range(SLOTS):
        TT.prefill_paged(tparams, _t(prompts[slot:slot + 1]), tcfg, tcache,
                         torch.tensor([slot], dtype=torch.int32),
                         _t(rows[slot:slot + 1]), calibrate=slot == 0)
    seq_cache = {k: v.clone() for k, v in tcache.items()}
    logits, tcache = TT.verify_step(tparams, _t(tokens), tcfg, tcache)
    for t in range(GAMMA):
        step_logits, seq_cache = TT.decode_step(tparams, _t(tokens[:, t]),
                                                tcfg, seq_cache)
        assert torch.equal(logits[:, t], step_logits), t
    for name in ("k_pages", "v_pages", "length"):
        assert torch.equal(tcache[name], seq_cache[name]), name


def test_tied_training_loss_and_grads_equal_reference():
    """OLMo's smoke twin (tied head, non-parametric LayerNorm) in training
    mode, float attention: the loss and every gradient, the tied table's
    (its embedding and its head use) included, within 1e-5 of JAX's."""
    jcfg = jget_arch("olmo_1b").smoke.replace(dtype="float32",
                                             attn_mode="float")
    tcfg = tget_arch("olmo_1b").smoke.replace(dtype="float32",
                                             attn_mode="float")
    jparams = jax.device_get(jsteps.init_params_fn(jcfg)(
        jax.random.PRNGKey(2)))
    tparams = bridge.from_jax_params(jparams, tcfg, device="cpu")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 17), dtype=np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, b, jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    (tloss, _), tgrads = tsteps.value_and_grad(
        tparams, {k: _t(v) for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    back = bridge.to_jax_layout(tgrads)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jgrads))
    assert "lm_head" not in back and back["final_norm"] == {}

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    jax.tree.map(close, back, jgrads)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_cli_smoke_serves(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                 "3", "--slots", "2", "--prompt-len", "10", "--gen", "4",
                 "--block-k", "8"])
    out = capsys.readouterr().out
    assert "[paged:dense:cpu] served 3 requests, 12 tokens" in out
    assert "0 leaked blocks" in out
