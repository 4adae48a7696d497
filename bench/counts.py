"""The yardstick's arithmetic, frozen with the benchmark: the H100's
data-sheet peaks, a served model's useful operations per token, and each
split-softmax kernel's least operations and bytes per launch.

Peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): 989 TFLOP/s bf16,
1,979 TOP/s int8, 3.35 TB/s HBM3.

A kernel's bound counts what its inputs need, whatever implements it:
each input byte read once, each output byte written once, and two
operations per multiply-add of the attention's two products (``q . k``
and ``e . v``) at each live (query, key) pair.
"""
from __future__ import annotations

from typing import Dict, Iterable

PEAK_FLOPS_BF16 = 989e12
PEAK_OPS_INT8 = 1979e12
HBM_BW = 3.35e12
LUT_BYTES = 4 * (256 + 256)            # the exp and the reciprocal tables


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time: the larger of bytes over HBM's rate and int8
    operations over the int8 peak."""
    return max(n_bytes / HBM_BW, n_ops / PEAK_OPS_INT8)


def prefill_attn_bound_s(hq: int, hkv: int, s: int, d: int) -> float:
    """Kernel 1 on one causal prompt of ``s`` tokens: int8 q, k, v in,
    f32 out."""
    pairs = hq * s * (s + 1) // 2
    n_bytes = hq * s * d + 2 * hkv * s * d + 4 * hq * s * d + LUT_BYTES
    return bound_s(n_bytes, pairs * 4 * d)


def decode_attn_bound_s(lens: Iterable[int], hq: int, hkv: int, d: int,
                        block_k: int) -> float:
    """Kernel 2 (fused, paged) over one decode step: f32 q in and out per
    slot, the int8 K and V of every live position, the table entries they
    sit in, the lengths and scales."""
    lens = list(lens)
    b, total = len(lens), sum(lens)
    tiles = sum(-(-n // block_k) for n in lens)
    n_bytes = (4 * b * hq * d + 2 * hkv * d * total + 4 * tiles
               + 4 * b * 3 + 4 * b * hq * d + LUT_BYTES)
    return bound_s(n_bytes, total * hq * 4 * d)


def active_params(c: Dict) -> int:
    """Parameters that one token multiplies: the attention and FFN
    matrices of every layer (a MoE layer's router, its top-k routed and its
    shared experts) and the LM head; the embedding is a lookup."""
    d, h, hkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // h
    attn = d * h * hd * 2 + d * hkv * hd * 2
    n = c["num_hidden_layers"]
    if "n_routed_experts" in c:
        dense_n = c["first_k_dense_replace"]
        f = c["moe_intermediate_size"]
        moe = (d * c["n_routed_experts"]
               + 3 * d * f * (c["num_experts_per_tok"]
                              + c.get("n_shared_experts", 0)))
    else:
        dense_n, moe = n, 0
    ffn = 3 * d * c["intermediate_size"]
    return n * attn + dense_n * ffn + (n - dense_n) * moe + d * c["vocab_size"]


def token_flops(c: Dict, context: int) -> float:
    """Useful FLOPs of one token that attends ``context`` keys: two per
    active parameter, and two per multiply-add of ``q . k`` and ``e . v``
    in every layer and query head."""
    hd = c["hidden_size"] // c["num_attention_heads"]
    attn = 4 * c["num_hidden_layers"] * c["num_attention_heads"] * hd * context
    return 2 * active_params(c) + attn


def prompt_flops(c: Dict, s: int) -> float:
    """A prompt of ``s`` tokens, token ``i`` attending ``i + 1`` keys."""
    hd = c["hidden_size"] // c["num_attention_heads"]
    pairs = s * (s + 1) // 2
    return (2 * active_params(c) * s
            + 4 * c["num_hidden_layers"] * c["num_attention_heads"] * hd * pairs)
