"""The weights that ``weights.py`` draws through a configuration's program
adapter (``bench/systems/<system>.py``) are the same bits, seed for seed,
as those the benchmark drew before the adapters were found by name: a
SHA-256 over every leaf, taken from that code at both cells' small
sizes, in float32 and in bfloat16."""
import hashlib

import pytest
import torch

import bench_tiny
import weights

DIGESTS = {
    ("deepseek-67b-int8.chat", "float32"):
        "6172d14ab5f6b2110edbc597f67a626919d6baae6ca7393d9bdc591c201c0ec8",
    ("deepseek-67b-int8.chat", "bfloat16"):
        "6172d14ab5f6b2110edbc597f67a626919d6baae6ca7393d9bdc591c201c0ec8",
    ("deepseek-moe-16b.code", "float32"):
        "2ceee7b14a112ff96d1634a566439a10fbc640b24f92059483ca1a69c9142cf0",
    ("deepseek-moe-16b.code", "bfloat16"):
        "5a82c37eedbc6caa4d20936be405f709c57cb7611b7db40df851f241002a4c23",
}


def _leaves(node, path=()):
    if isinstance(node, torch.Tensor):
        yield path, node
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k], path + (k,))
    else:
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))


def digest(W) -> str:
    h = hashlib.sha256()
    for path, t in _leaves(W):
        h.update(repr((path, tuple(t.shape), str(t.dtype))).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,dtype", sorted(DIGESTS))
def test_weights_are_the_same_bits(name, dtype):
    _, _, conf, _ = bench_tiny.tiny(name, dtype)
    W = weights.make_weights(conf, 2 ** 31 + 7, "cpu")
    assert digest(W) == DIGESTS[name, dtype]
