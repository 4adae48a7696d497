"""The model's weights, made by the benchmark on the device from the seed:
one buffer a dtype, drawn in chunks of 2^30 elements by one
``torch.Generator``, each leaf a view into it.  These are the inputs that
both sides read: the system through its adapter's ``program_params`` (the
same tensors in the port's layout) and the plain reference directly.

What the leaves are, their shapes, stds and kinds, is the configuration's
program adapter's ``plan`` (``bench/systems/<system>.py``, found by the
configuration's ``system``); the drawing is the same for every one: a
``compute`` or ``f32`` leaf is a standard normal times its std, an
``int8`` one uniform over [-127, 127] with one f32 scale ``std /
INT8_STD`` (``{"q": int8, "s": f32 (1, 1)}``, standing for ``f32(q) *
s``), so that it has the same std.  ``norm`` is ones, one tensor shared by
every norm.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

import spec

INT8_STD = math.sqrt((255 ** 2 - 1) / 12)     # uniform over [-127, 127]
CHUNK = 1 << 30
ALIGN = 256                                    # elements between leaves


def _set(tree: Dict, path: tuple, leaf) -> None:
    node = tree
    for key in path[:-1]:
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if key == "layers" else {})
    node[path[-1]] = leaf


def make_weights(conf: Dict, seed: int, device) -> Dict:
    """``W`` for the configuration ``conf`` (a ``bench/configs`` file)."""
    plan = spec.system_module(conf["system"]).plan(conf)
    dtypes = {"int8": torch.int8, "f32": torch.float32,
              "compute": getattr(torch, conf["serve"]["dtype"])}
    offsets: Dict[str, int] = {k: 0 for k in dtypes}
    places = []
    for path, shape, std, kind in plan:
        places.append(offsets[kind])
        offsets[kind] += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(seed)
    bufs = {}
    for kind, total in offsets.items():
        if not total:
            continue
        buf = torch.empty(total, dtype=dtypes[kind], device=device)
        for lo in range(0, total, CHUNK):
            part = buf[lo:lo + CHUNK]
            if kind == "int8":
                part.random_(-127, 128, generator=gen)
            else:
                part.normal_(generator=gen)
        bufs[kind] = buf
    W: Dict = {"norm": torch.ones(conf["config"]["hidden_size"],
                                  dtype=torch.float32, device=device)}
    for (path, shape, std, kind), at in zip(plan, places):
        t = bufs[kind][at:at + math.prod(shape)].view(shape)
        if kind == "int8":
            leaf = {"q": t, "s": torch.full((1, 1), std / INT8_STD,
                                            dtype=torch.float32, device=device)}
        else:
            leaf = {"w": t.mul_(std)}
        _set(W, path, leaf)
    return W

