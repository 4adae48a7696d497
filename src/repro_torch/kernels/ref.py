"""Float attention baseline (port of ``repro/kernels/ref.py``: the float
3-pass safe-softmax attention of ``attn_mode="float"``, with its GQA
expansion and mask).  The int8 oracles of the reference's file are the
kernels' plain versions here (``splitmax_attn.splitmax_attention_plain``
and the decode and verify wrappers)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def _expand_gqa(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """Repeat kv heads to match query heads: (B,Hkv,S,D) -> (B,Hq,S,D)."""
    group = n_q_heads // k.shape[1]
    if group == 1:
        return k
    return torch.repeat_interleave(k, group, dim=1)


def _attn_mask(sq: int, sk: int, *, causal: bool, window: Optional[int],
               device=None) -> torch.Tensor:
    """(sq, sk) bool mask, True = attend."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def safe_softmax_attention_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window: Optional[int] = None,
                               mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Float 3-pass safe-softmax attention (B,Hq,Sq,D) x (B,Hkv,Sk,D) ->
    (B,Hq,Sq,D) f32; fully-masked rows give 0."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    k = _expand_gqa(k, hq)
    v = _expand_gqa(v, hq)
    sk = k.shape[2]
    z = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(d)
    m = _attn_mask(sq, sk, causal=causal, window=window, device=q.device)
    if mask is not None:
        m = m & mask
    z = torch.where(m, z, -math.inf)
    p = torch.softmax(z, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
