"""Sampled token selection in the port (``scheduler.make_sampler`` and the
count-addressed ``scheduler.RequestKeys``).

The reference draws with ``jax.random``, which torch cannot reproduce, so
sampled tokens are compared within the port only, with one exception: at
``top_p = 1e-9`` only the top token survives the nucleus, and both packages
must then emit the greedy tokens.  Within the port: greedy selection is the
argmax path, a seed fixes the tokens and another seed changes them, a
preempted sampled run equals the unpreempted one (a request's n-th draw
depends on the seed, its id and n only), padding lanes are never drawn, and
draws follow the softmax of the scaled logits.
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
from repro_torch.launch import scheduler as sched
from repro_torch.launch import serve as tserve

torch.set_num_threads(1)

KW = dict(slots=4, gen=12, cache_kind="paged", block_k=8, max_len=40)
SAMPLED = dict(temperature=0.8, top_p=0.95, sample_seed=3)


@pytest.fixture(scope="module")
def rig():
    jcfg = jget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    tcfg = tget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(2))
    tparams = bridge.from_jax_params(jax.device_get(jparams), tcfg,
                                     device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, 16, dtype=np.int32)
               for _ in range(8)]
    gens = [12, 10, 12, 8, 12, 10, 8, 12]
    sampled = tserve.serve(tparams, tcfg, prompts, gens=gens, **KW, **SAMPLED)
    return jcfg, jparams, tcfg, tparams, prompts, gens, sampled


def test_mix32_is_the_wrapping_32_bit_hash():
    """The 16-bit-half products equal plain wrapping uint32 arithmetic, on
    Python ints and on int64 tensors alike."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    x[:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]

    def ref(v):
        v = v.astype(np.uint64)
        v ^= v >> np.uint64(16)
        v = (v * np.uint64(0x7FEB352D)) & np.uint64(0xFFFFFFFF)
        v ^= v >> np.uint64(15)
        v = (v * np.uint64(0x846CA68B)) & np.uint64(0xFFFFFFFF)
        return v ^ (v >> np.uint64(16))

    want = ref(x)
    got = sched._mix32(torch.as_tensor(x.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint64), want)
    assert [sched._mix32(int(v)) for v in x[:16]] == [int(v)
                                                      for v in want[:16]]
    assert int(got.min()) >= 0 and int(got.max()) < 2 ** 32


def test_request_keys_are_count_addressed():
    """A key depends on (seed, rid, drawn) only, never on call order; other
    seeds, ids and counts give other keys; any int seed works."""
    a, b = sched.RequestKeys(5), sched.RequestKeys(5)
    grid = [(r, n) for r in range(6) for n in range(6)]
    ka = {rn: a.key(*rn) for rn in grid}
    kb = {rn: b.key(*rn) for rn in reversed(grid)}
    assert ka == kb
    assert len(set(ka.values())) == len(grid)
    assert sched.RequestKeys(6).key(0, 0) != a.key(0, 0)
    for seed in (0, -1, 2 ** 40 + 7):
        k = sched.RequestKeys(seed)
        assert 0 <= k.key(3, 9) < 2 ** 32 and 0 <= k.base < 2 ** 32


def test_greedy_selector_is_argmax_with_finite_guard():
    """temperature 0 is torch.argmax, first maximum on ties, and the guard
    flags every row that is not all finite."""
    logits = torch.randn(5, 40)
    logits[1, 3] = logits[1, 17] = 9.0           # a tie: the first wins
    logits[2, 5] = torch.nan
    logits[4, 0] = torch.inf
    toks, ok = sched.make_sampler(0.0, 1.0, 32)(logits, None)
    assert torch.equal(toks, torch.argmax(logits, dim=-1))
    assert int(toks[1]) == 3
    assert ok.tolist() == [True, True, False, True, False]


def test_padding_lanes_are_never_drawn():
    """Huge logits on the lanes past vocab_size change nothing; the guard
    is computed on the raw row."""
    vocab, lanes = 24, 32
    sample = sched.make_sampler(1.0, 1.0, vocab)
    keys = sched.RequestKeys(0)
    logits = torch.randn(256, lanes)
    logits[:, vocab:] = 1e4
    toks, ok = sample(logits, [keys.key(r, 0) for r in range(256)])
    assert int(toks.max()) < vocab and bool(ok.all())
    clean = logits.clone()
    clean[:, vocab:] = -5.0
    assert torch.equal(toks, sample(clean, [keys.key(r, 0)
                                            for r in range(256)])[0])


def test_draws_follow_the_softmax_and_the_nucleus():
    """Over many keys, draw frequencies follow softmax(logits / T); top_p
    keeps the smallest prefix of mass >= top_p and no lane outside it."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -3.0])
    n = 20000
    keys = [sched.RequestKeys(1).key(r, 7) for r in range(n)]
    rows = logits.expand(n, -1)
    for t in (1.0, 0.5):
        toks, _ = sched.make_sampler(t, 1.0, 6)(rows, keys)
        freq = torch.bincount(toks, minlength=6).double() / n
        want = torch.softmax(logits.double() / t, dim=0)
        assert float((freq - want).abs().max()) < 0.015, (t, freq, want)
    p = torch.softmax(logits, dim=0)             # 0.61, 0.22, 0.14, ...
    toks, _ = sched.make_sampler(1.0, 0.7, 6)(rows, keys)
    assert set(toks.tolist()) == {0, 1}
    freq = float((toks == 0).double().mean())
    assert abs(freq - float(p[0] / (p[0] + p[1]))) < 0.015


def test_seed_fixes_the_tokens(rig):
    """The same seed gives the same tokens, another seed others; every
    token in the vocab."""
    _, _, tcfg, tparams, prompts, gens, sampled = rig
    again = tserve.serve(tparams, tcfg, prompts, gens=gens, **KW, **SAMPLED)
    other = tserve.serve(tparams, tcfg, prompts, gens=gens, **KW,
                         **dict(SAMPLED, sample_seed=4))
    assert again["finished"] == sampled["finished"]
    assert other["finished"] != sampled["finished"]
    for stats in (sampled, other):
        assert all(len(stats["finished"][r]) == gens[r] for r in range(8))
        assert all(0 <= t < tcfg.vocab_size
                   for toks in stats["finished"].values() for t in toks)


@pytest.mark.parametrize("pool", [13, 7])
def test_preempted_sampled_run_equals_unpreempted(rig, pool):
    _, _, tcfg, tparams, prompts, gens, sampled = rig
    tight = tserve.serve(tparams, tcfg, prompts, gens=gens, pool_blocks=pool,
                         preempt_policy="longest", **KW, **SAMPLED)
    assert tight["preemptions"] > 0
    assert tight["resumes"] == tight["preemptions"]
    assert tight["finished"] == sampled["finished"]
    assert tight["leaked_blocks"] == 0


def test_tiny_top_p_gives_greedy_tokens_like_reference(rig):
    """Only the top token survives top_p = 1e-9: the port's sampled run is
    its greedy run and the reference's sampled run at the same top_p."""
    jcfg, jparams, tcfg, tparams, prompts, gens, _ = rig
    kw = dict(KW, gens=gens, temperature=0.8, top_p=1e-9)
    greedy = tserve.serve(tparams, tcfg, prompts, **dict(KW, gens=gens))
    got = tserve.serve(tparams, tcfg, prompts, sample_seed=9, **kw)
    want = jserve.serve(jparams, jcfg, prompts, **kw)
    assert got["finished"] == greedy["finished"] == want["finished"]


def test_serve_dense_sampled_is_deterministic(rig):
    _, _, tcfg, tparams, prompts, gens, _ = rig
    kw = dict(slots=3, gen=12, gens=gens, cache_kind="dense", **SAMPLED)
    one = tserve.serve(tparams, tcfg, prompts, **kw)
    two = tserve.serve(tparams, tcfg, prompts, warmup=True, repeats=2, **kw)
    other = tserve.serve(tparams, tcfg, prompts,
                         **dict(kw, sample_seed=4))
    assert one["finished"] == two["finished"] != other["finished"]
    greedy = tserve.serve(tparams, tcfg, prompts, slots=3, gen=12, gens=gens,
                          cache_kind="dense")
    tiny = tserve.serve(tparams, tcfg, prompts, **dict(kw, top_p=1e-9))
    assert tiny["finished"] == greedy["finished"]


def test_warmup_and_repeats_keep_the_tokens(rig):
    """The warm-up pass runs before the clock on a scratch pool and
    repeats rerun the whole schedule: neither changes a token."""
    _, _, tcfg, tparams, prompts, gens, sampled = rig
    stats = tserve.serve(tparams, tcfg, prompts, gens=gens, warmup=True,
                         repeats=2, **KW, **SAMPLED)
    assert stats["finished"] == sampled["finished"]
    assert (stats["warmup_prefills"], stats["warmup_decode_steps"]) == (2, 1)
    assert sampled["warmup_prefills"] == 0


def test_speculative_rejects_sampling_and_deadline_ms(rig):
    _, _, tcfg, tparams, prompts, gens, _ = rig
    with pytest.raises(ValueError, match="greedy-only"):
        tserve.serve(tparams, tcfg, prompts, gens=gens, draft="self",
                     temperature=0.5, **KW)
    with pytest.raises(ValueError, match="deadline_ms"):
        tserve.serve(tparams, tcfg, prompts, gens=gens, draft="self",
                     deadline_ms=100.0, **KW)
    with pytest.raises(ValueError, match="deadlines"):
        tserve.serve(tparams, tcfg, prompts, gens=gens, deadline_steps=9,
                     **dict(KW, cache_kind="dense"))


def test_cli_samples_on_cpu(capsys):
    argv = ["--smoke", "--device", "cpu", "--requests", "4", "--slots", "2",
            "--prompt-len", "12", "--gen", "6", "--block-k", "8",
            "--temperature", "0.8", "--top-p", "0.9"]
    outs = []
    for extra in ([], ["--pool-blocks", "5", "--preempt-policy", "newest"]):
        tserve.main(argv + extra)
        outs.append(capsys.readouterr().out)
    assert all("served 4 requests, 24 tokens" in o for o in outs)
    tail = [o[o.index("  req 0"):] for o in outs]
    assert tail[0] == tail[1]
