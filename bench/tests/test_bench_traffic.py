"""The traffic generator: the same seed gives the same requests, and every
seed serves the same lengths, the first requests in another order."""
import numpy as np
import pytest

import bench_tiny  # noqa: F401  (puts bench/ and src/ on the path)

import spec
import traffic

MIXES = ("conv_c16", "code_c32")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = spec.load_traffic(name)
    a = traffic.make_requests(mix, 2 ** 31 + 11, 102400)
    b = traffic.make_requests(mix, 2 ** 31 + 11, 102400)
    assert a[1] == b[1]
    assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_permute_the_same_lengths(name):
    mix = spec.load_traffic(name)
    k, c = mix["block"], mix["clients"]
    p1, g1 = traffic.lengths(mix, 3)
    p2, g2 = traffic.lengths(mix, 2 ** 31 + 4)
    # the first requests, all admitted before the window, in another order
    # among the slots; every request after them the same on every seed
    assert not np.array_equal(p1[:c], p2[:c])
    assert sorted(zip(p1[:c], g1[:c])) == sorted(zip(p2[:c], g2[:c]))
    assert np.array_equal(p1[c:], p2[c:]) and np.array_equal(g1[c:], g2[c:])
    u = (np.arange(k) + 0.5) / k
    for i in range(c, mix["requests"] - k + 1, k):
        assert sorted(p1[i:i + k]) == sorted(traffic.quantile(mix["prompt_len"], u))
        assert sorted(g1[i:i + k]) == sorted(traffic.quantile(mix["gen_len"], u))
    assert p1[0] == p2[0] == p1[:c].max()
    # the first requests' lengths left are shorter, on the whole, than a
    # whole request's
    assert g1[:c].mean() < g1[c:].mean()
    lo, hi = mix["prompt_len"]["lo"], mix["prompt_len"]["hi"]
    assert lo <= p1.min() and p1.max() <= hi
    assert traffic.max_len(mix) == hi + mix["gen_len"]["hi"]


@pytest.mark.parametrize("name", MIXES)
def test_mix_cites_its_source(name):
    mix = spec.load_traffic(name)
    assert "arXiv:" in mix["source"] and "AzurePublicDataset" in mix["source"]


def test_tokens_in_vocab_and_lengths_match():
    mix = spec.load_traffic("conv_c16")
    prompts, gens = traffic.make_requests(mix, 7, 1000)
    p, g = traffic.lengths(mix, 7)
    assert [len(x) for x in prompts] == list(p) and gens == list(g)
    assert all(0 <= x.min() and x.max() < 1000 for x in prompts)


def test_only_a_closed_loop():
    mix = dict(spec.load_traffic("conv_c16"), loop="open")
    with pytest.raises(ValueError):
        traffic.make_requests(mix, 1, 100)
