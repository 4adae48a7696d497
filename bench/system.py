"""The system under test, as the benchmark drives it: the port's config
from a ``bench/configs`` file, the benchmark's weights handed over in the
port's layout (the same tensors, no copy), and the serving engine of
``launch/serve.py::make_engine``.  Nothing here computes; the port does.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


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
