"""The program adapter of a served decoder (a Llama-style dense SwiGLU
decoder, or DeepSeekMoE): the port's config from a ``bench/configs`` file,
the plan of the weights the benchmark draws for it, those weights handed
over in the port's layout (the same tensors, no copy), and the serving
engine of ``launch/serve.py::make_engine``.  Nothing here computes; the
port does.

Layout of the weights (``W``): ``embed``, ``head`` and per layer ``wq``,
``wk``, ``wv``, ``wo`` and either ``w_in``, ``w_gate``, ``w_out`` (a dense
SwiGLU) or ``moe`` = {``router``, ``w_in``, ``w_gate``, ``w_out`` (stacked
over the experts), ``shared`` = {``w_in``, ``w_gate``, ``w_out``}}.  A
leaf is a dict: ``{"w": float tensor}``, or an int8 one ``{"q": int8, "s":
f32 (1, 1)}`` that stands for ``f32(q) * s``.  Norm scales are ones
(``norm``, one tensor shared by every norm).

Each leaf's std is the port's initializer's (``layers.linear_init``,
``moe.moe_init``); ``weights.py`` draws it.  The router and the LM head of
a float model are f32 (as served); the rest is in the compute dtype, and so
are the stacked experts of an int8 model (the port serves them so).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def routed(conf: Dict) -> bool:
    """Whether the configuration has routed experts, whose routing the
    check follows (``trace.routing`` records it)."""
    return "n_routed_experts" in conf["config"]


def plan(conf: Dict) -> List[Tuple[tuple, tuple, float, str]]:
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


def model_config(conf: Dict):
    from repro_torch.models.config import ModelConfig, MoEConfig
    c, s = conf["config"], conf["serve"]
    if c["rms_norm_eps"] != 1e-6 or c["hidden_act"] != "silu":
        raise ValueError(f"{conf['name']}: the port's decoder has RMSNorm "
                         f"eps 1e-6 and SwiGLU only")
    moe = None
    if "n_routed_experts" in c:
        moe = MoEConfig(n_experts=c["n_routed_experts"],
                        top_k=c["num_experts_per_tok"],
                        d_ff_expert=c["moe_intermediate_size"],
                        n_shared=c.get("n_shared_experts", 0),
                        capacity_factor=s["moe_capacity_factor"],
                        first_dense_layers=c["first_k_dense_replace"])
    return ModelConfig(
        name=conf["name"], family="moe" if moe else "dense",
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // c["num_attention_heads"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        norm="rmsnorm", act="silu", rope_theta=float(c["rope_theta"]),
        tie_embeddings=c["tie_word_embeddings"], dtype=s["dtype"],
        serve_param_dtype=s["serve_param_dtype"],
        logits_dtype=s["logits_dtype"], scale_z=s["scale_z"], moe=moe)


def _linear(leaf: Dict) -> Dict:
    return {"w_q": leaf["q"], "w_s": leaf["s"]} if "q" in leaf else \
        {"w": leaf["w"]}


def _table(leaf: Dict) -> Dict:
    return {"table_q": leaf["q"], "table_s": leaf["s"]} if "q" in leaf else \
        {"table": leaf["w"]}


def program_params(W: Dict) -> Dict:
    """``W`` in the port's parameter layout (``models/transformer.py``)."""
    norm = {"scale": W["norm"]}
    layers = []
    for lw in W["layers"]:
        lp = {"norm1": norm, "norm2": norm,
              "attn": {k: _linear(lw[k]) for k in ("wq", "wk", "wv", "wo")}}
        if "moe" in lw:
            m = lw["moe"]
            lp["moe"] = {"router": _linear(m["router"]),
                         **{k: m[k]["w"] for k in ("w_in", "w_gate", "w_out")}}
            if "shared" in m:
                lp["moe"]["shared"] = {k: _linear(v)
                                       for k, v in m["shared"].items()}
        else:
            lp["mlp"] = {k: _linear(lw[k]) for k in ("w_in", "w_gate", "w_out")}
        layers.append(lp)
    return {"embed": _table(W["embed"]), "layers": layers,
            "final_norm": norm, "lm_head": _linear(W["head"])}


def make_engine(conf: Dict, W: Dict, prompts: List[np.ndarray], *,
                slots: int, max_len: int):
    from repro_torch.launch.serve import make_engine as program_engine
    cfg = model_config(conf)
    return program_engine(program_params(W), cfg, prompts, slots=slots,
                          max_len=max_len, block_k=conf["serve"]["block_k"])
