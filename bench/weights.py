"""The model's weights, made by the benchmark on the device from the seed:
one buffer a dtype, drawn in chunks of 2^30 elements by one
``torch.Generator``, each leaf a view into it.  These are the inputs that
both sides read: the system through ``system.program_params`` (the same
tensors in the port's layout) and the plain reference directly.

Layout (``W``): ``embed``, ``head`` and per layer ``wq``, ``wk``, ``wv``,
``wo`` and either ``w_in``, ``w_gate``, ``w_out`` (a dense SwiGLU) or
``moe`` = {``router``, ``w_in``, ``w_gate``, ``w_out`` (stacked over the
experts), ``shared`` = {``w_in``, ``w_gate``, ``w_out``}}.  A leaf is a
dict: ``{"w": float tensor}``, or an int8 one ``{"q": int8, "s": f32
(1, 1)}`` that stands for ``f32(q) * s``.  Norm scales are ones (``norm``,
one tensor shared by every norm).

Drawn values: a float leaf is a standard normal times the initializer's
std (the port's ``layers.linear_init`` and ``moe.moe_init`` scales); an
int8 leaf is uniform over [-127, 127] with ``s = std / INT8_STD``, so that
it has the same std.  The router and the LM head of a float model are f32
(as served); the rest is in the compute dtype, and so are the stacked
experts of an int8 model (the port serves them so).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

INT8_STD = math.sqrt((255 ** 2 - 1) / 12)     # uniform over [-127, 127]
CHUNK = 1 << 30
ALIGN = 256                                    # elements between leaves

def _plan(conf: Dict) -> List[Tuple[tuple, tuple, float, str]]:
    """(path, shape, std, kind) of every leaf, in draw order; kind is
    ``int8``, ``compute`` or ``f32``."""
    c, s = conf["config"], conf["serve"]
    d, h, hkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // h
    n = c["num_hidden_layers"]
    v = c["vocab_size"]
    int8 = s["serve_param_dtype"] == "int8"
    lin = "int8" if int8 else "compute"
    f32 = "int8" if int8 else "f32"
    out_std = (h * hd) ** -0.5 / (2 * n) ** 0.5
    plan = [(("embed",), (v, d), 0.02, lin)]
    n_dense = c.get("first_k_dense_replace", n) if "n_routed_experts" in c else n
    for i in range(n):
        lp = ("layers", i)
        plan += [(lp + ("wq",), (d, h * hd), d ** -0.5, lin),
                 (lp + ("wk",), (d, hkv * hd), d ** -0.5, lin),
                 (lp + ("wv",), (d, hkv * hd), d ** -0.5, lin),
                 (lp + ("wo",), (h * hd, d), out_std, lin)]
        if i < n_dense:
            f = c["intermediate_size"]
            plan += [(lp + ("w_in",), (d, f), d ** -0.5, lin),
                     (lp + ("w_gate",), (d, f), d ** -0.5, lin),
                     (lp + ("w_out",), (f, d), f ** -0.5 / (2 * n) ** 0.5, lin)]
            continue
        e, f = c["n_routed_experts"], c["moe_intermediate_size"]
        m = lp + ("moe",)
        plan += [(m + ("router",), (d, e), 0.02, f32),
                 (m + ("w_in",), (e, d, f), d ** -0.5, "compute"),
                 (m + ("w_gate",), (e, d, f), d ** -0.5, "compute"),
                 (m + ("w_out",), (e, f, d), f ** -0.5 / (2 * n) ** 0.5,
                  "compute")]
        if c.get("n_shared_experts"):
            w = c["n_shared_experts"] * f
            sh = m + ("shared",)
            plan += [(sh + ("w_in",), (d, w), d ** -0.5, lin),
                     (sh + ("w_gate",), (d, w), d ** -0.5, lin),
                     (sh + ("w_out",), (w, d), f ** -0.5 / (2 * n) ** 0.5, lin)]
    plan.append((("head",), (d, v), d ** -0.5, f32))
    return plan


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
    plan = _plan(conf)
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

