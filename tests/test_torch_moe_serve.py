"""Serving the MoE family: the port's greedy token streams against
``repro.launch.serve``'s on the DeepSeekMoE-16B and Mixtral-8x22B smoke
configs in float32, from the same bridged parameters.

The churn workload of ``benchmarks/serve_bench.py`` (requests > slots,
staggered generation lengths, ``block_k = 8`` so prompts straddle blocks
and slots grow mid-decode) through the paged pool, plain and
self-drafted speculative, and through the dense ``(slots, max_len)``
cache.  Prompts of 24 tokens and up to 16 generated ones carry Mixtral's
sequences past its 32-position window.  Tokens must be equal exactly, and
no block may leak.  The CLI's ``--smoke`` run prints the reference CLI's
tokens when it is given the reference's parameters.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_arch as tget_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

MOE_ARCHS = ["deepseek_moe_16b", "mixtral_8x22b"]
KW = dict(slots=3, gen=16, block_k=8)


def _bridged(arch, seed=0):
    jcfg = jget_arch(arch).smoke.replace(dtype="float32")
    tcfg = tget_arch(arch).smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(seed))
    tparams = bridge.from_jax_params(jax.device_get(jparams), tcfg,
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=MOE_ARCHS)
def rig(request):
    jcfg, jparams, tcfg, tparams = _bridged(request.param)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, 24, dtype=np.int32)
               for _ in range(6)]
    gens = [int(g) for g in rng.integers(KW["gen"] // 2, KW["gen"] + 1, 6)]
    return jcfg, jparams, tcfg, tparams, prompts, gens


def test_paged_churn_tokens_equal_reference(rig):
    jcfg, jparams, tcfg, tparams, prompts, gens = rig
    want = jserve.serve(jparams, jcfg, prompts, gens=gens, **KW)
    got = tserve.serve(tparams, tcfg, prompts, gens=gens, **KW)
    assert got["finished"] == want["finished"]
    assert got["served"] == want["served"] == len(prompts)
    for key in ("decode_steps", "slot_prefills", "total_tokens"):
        assert got[key] == want[key], key
    assert got["leaked_blocks"] == want["leaked_blocks"] == 0


def test_speculative_churn_tokens_equal_reference(rig):
    jcfg, jparams, tcfg, tparams, prompts, gens = rig
    want = jserve.serve(jparams, jcfg, prompts, gens=gens, draft="self",
                        gamma=4, **KW)
    got = tserve.serve(tparams, tcfg, prompts, gens=gens, draft="self",
                       gamma=4, **KW)
    assert got["finished"] == want["finished"]
    for key in ("verify_steps", "drafts_proposed", "drafts_accepted",
                "slot_prefills"):
        assert got[key] == want[key], key
    assert got["leaked_blocks"] == 0


def test_dense_cache_churn_tokens_equal_reference(rig):
    jcfg, jparams, tcfg, tparams, prompts, gens = rig
    want = jserve.serve_dense(jparams, jcfg, prompts, slots=KW["slots"],
                              gen=KW["gen"], gens=gens)
    got = tserve.serve(tparams, tcfg, prompts, slots=KW["slots"],
                       gen=KW["gen"], gens=gens, cache_kind="dense")
    assert got["finished"] == want["finished"]
    assert got["batch_prefills"] == want["batch_prefills"] > 1
    assert got["decode_steps"] == want["decode_steps"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cli_smoke_tokens_equal_reference_cli(arch, capsys, monkeypatch):
    """Both CLIs on the same flags; the port's ``init_params`` hands out the
    reference CLI's parameters (``PRNGKey(seed)``), bridged."""
    argv = ["--arch", arch, "--smoke", "--requests", "4", "--slots", "2",
            "--prompt-len", "12", "--gen", "6", "--block-k", "8"]
    jserve.main(argv)
    want = capsys.readouterr().out

    def reference_params(cfg, *, seed, device, serving):
        assert serving and cfg.name == jget_arch(arch).smoke.name
        jcfg = jget_arch(arch).smoke.replace(dtype="float32")
        return bridge.from_jax_params(jax.device_get(
            jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(seed))), cfg,
            device=device)

    monkeypatch.setattr(TT, "init_params", reference_params)
    tserve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert "[paged:moe:cpu] served 4 requests, 24 tokens" in got
    assert "0 leaked blocks" in got

    def req_lines(out):
        return [ln for ln in out.splitlines() if ln.startswith("  req ")]

    assert len(req_lines(want)) == 4
    assert req_lines(got) == req_lines(want)
