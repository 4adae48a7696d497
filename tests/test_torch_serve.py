"""The port's serving slice end to end against ``repro.launch.serve``.

Both packages serve the smoke churn workload (requests > slots, staggered
generation lengths, ``block_k = 8`` so prompts straddle blocks and slots
grow mid-decode) from the same bridged parameters: their greedy token
streams must be equal and no block may leak.
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


def _prompts_gens(requests, prompt_len, gen, seed, vocab):
    """benchmarks/serve_bench.py's churn workload: gens staggered in
    [gen/2, gen] so retirements never synchronize."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, prompt_len, dtype=np.int32)
               for _ in range(requests)]
    gens = [int(g) for g in rng.integers(gen // 2, gen + 1, requests)]
    return prompts, gens


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    tcfg = tget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(0))
    tparams = bridge.from_jax_params(jax.device_get(jparams), tcfg,
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("seed,slots,prompt_len", [(0, 3, 20), (1, 4, 29)])
def test_churn_greedy_tokens_equal_reference(smoke, seed, slots, prompt_len):
    jcfg, jparams, tcfg, tparams = smoke
    prompts, gens = _prompts_gens(9, prompt_len, 12, seed, jcfg.vocab_size)
    want = jserve.serve_paged(jparams, jcfg, prompts, slots=slots, gen=12,
                              gens=gens, block_k=8)
    got = tserve.serve_paged(tparams, tcfg, prompts, slots=slots, gen=12,
                             gens=gens, block_k=8)
    assert got["finished"] == want["finished"]
    assert got["served"] == want["served"] == len(prompts)
    assert got["leaked_blocks"] == want["leaked_blocks"] == 0
    assert got["decode_steps"] == want["decode_steps"]
    assert got["slot_prefills"] == want["slot_prefills"] == len(prompts)
    assert got["total_tokens"] == sum(gens)
    assert got["p99_step_ms"] >= got["p50_step_ms"] > 0


def test_pool_exhaustion_raises_not_degrades(smoke):
    """Two admitted slots fill a 6-block pool; the first growth past it
    preempts one request and resumes it later, as the reference does, and
    the tokens stay the reference's.  A pool that cannot hold one sequence
    raises up front."""
    jcfg, jparams, tcfg, tparams = smoke
    prompts, _ = _prompts_gens(2, 20, 12, 0, tcfg.vocab_size)
    kw = dict(slots=2, gen=12, block_k=8, pool_blocks=7)
    want = jserve.serve_paged(jparams, jcfg, prompts, **kw)
    got = tserve.serve_paged(tparams, tcfg, prompts, **kw)
    assert got["preemptions"] >= 1
    assert got["resumes"] == got["preemptions"] == want["preemptions"]
    assert got["finished"] == want["finished"]
    assert got["leaked_blocks"] == 0
    with pytest.raises(ValueError):                  # cannot hold one sequence
        tserve.serve_paged(tparams, tcfg, prompts, slots=2, gen=12,
                           block_k=8, pool_blocks=5)


def test_cli_serves_on_cpu(capsys):
    tserve.main(["--smoke", "--device", "cpu", "--requests", "3", "--slots",
                 "2", "--prompt-len", "10", "--gen", "4", "--block-k", "8"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert "0 leaked blocks" in out


def test_cuda_entry_points_do_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    cfg = tget_arch("tinyllama_1p1b").smoke
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.make_paged_cache(cfg, 2, 16, block_k=8)
