"""Blocked split-softmax attention of QAT training (port of
``repro/kernels/blocked.py``: ``blocked_fakequant_attention`` and
``_chunk_mask``).

CIMple's split softmax has no running max, so the k axis is a plain
accumulation over K/V chunks, ``acc += E(z_chunk) . V_chunk`` and ``s +=
sum E(z_chunk)``, with one division at the end.  Scores are STE
fake-quantized floats (the training numerics of the int8 datapath).  This is
plain PyTorch on the card as on the CPU: the reference runs it as an XLA
scan, not as a Pallas kernel.

Each chunk's contribution is computed under ``torch.utils.checkpoint`` (the
counterpart of the reference's ``jax.checkpoint`` on the scan body), so the
backward recomputes a chunk's ``(B, Hq, Sq, block_k)`` scores instead of
keeping them alive.  The sums run in the reference's order, chunk after
chunk from zero.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import quantization as qlib
from repro_torch.core.lut import LUTConfig, Z_QUANT_MAX
from repro_torch.core.split_softmax import lut_floor


def _chunk_mask(sq: int, bk: int, base: int, *, causal: bool,
                window: Optional[int], kv_valid_len: Optional[int],
                q_offset: int = 0, device=None) -> torch.Tensor:
    """(sq, bk) bool mask for a k-chunk starting at absolute position
    ``base``; query row i is absolute position ``q_offset + i``."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = base + torch.arange(bk, device=device)[None, :]
    m = torch.ones((sq, bk), dtype=torch.bool, device=device)
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > qpos - window)
    if kv_valid_len is not None:
        m = m & (kpos < kv_valid_len)
    return m


def blocked_fakequant_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: LUTConfig, *,
    causal: bool = True,
    window: Optional[int] = None,
    kv_valid_len: Optional[int] = None,
    block_k: int = 512,
    remat: bool = True,
    score_dtype: torch.dtype = torch.float32,
    triangular: bool = False,
) -> torch.Tensor:
    """Training-mode (STE) split-softmax attention over k chunks:
    (B,Hq,Sq,D) x (B,Hkv,Sk,D) -> (B,Hq,Sq,D) f32, differentiable.

    ``score_dtype=torch.bfloat16`` runs ``e`` and the ``e . V`` product in
    bf16 (the sums stay f32); ``triangular`` processes a causal run in q
    chunks, each over its live k prefix only.  ``block_k`` is clamped to Sk
    and must divide it.
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    block_k = min(block_k, sk)
    if sk % block_k:
        raise ValueError(f"block_k {block_k} does not divide Sk {sk}")
    nk = sk // block_k
    dev = q.device
    s_z = torch.tensor(cfg.scale_z, dtype=torch.float32, device=dev)
    ceiling = Z_QUANT_MAX * s_z
    rsqrt_d = float(np.float32(1.0) / np.sqrt(np.float32(d)))   # f32
    floor = lut_floor(cfg)

    qg = q.reshape(b, hkv, g, sq, d).to(torch.float32)
    kf = k.reshape(b, hkv, nk, block_k, d).to(torch.float32)
    vf = v.reshape(b, hkv, nk, block_k, d).to(torch.float32)

    def chunk(q_chunk, kc, vc, base, q_offset):
        """One k chunk's (e . V, sum e) against q_chunk (b,hkv,g,sq_c,d)."""
        sq_c = q_chunk.shape[3]
        z = torch.einsum("bkgqd,bkcd->bkgqc", q_chunk, kc) * rsqrt_d
        zdot = qlib.fake_quant(z, s_z) - ceiling
        e = torch.exp(zdot).to(score_dtype)
        e = torch.where(zdot < floor, 0.0, e)
        mask = _chunk_mask(sq_c, block_k, base, causal=causal, window=window,
                           kv_valid_len=kv_valid_len, q_offset=q_offset,
                           device=dev)
        e = torch.where(mask, e, 0.0)
        pv = torch.einsum("bkgqc,bkcd->bkgqd", e, vc.to(score_dtype))
        return pv.to(torch.float32), torch.sum(e.to(torch.float32), dim=-1)

    def run(q_chunk, q_offset, n_live):
        acc = torch.zeros(q_chunk.shape, dtype=torch.float32, device=dev)
        s = torch.zeros(q_chunk.shape[:4], dtype=torch.float32, device=dev)
        for idx in range(n_live):
            args = (q_chunk, kf[:, :, idx], vf[:, :, idx], idx * block_k,
                    q_offset)
            if remat:
                pv, se = checkpoint(chunk, *args, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                pv, se = chunk(*args)
            acc = acc + pv
            s = s + se
        return acc / torch.clamp_min(s, 1e-30)[..., None]

    if causal and triangular and sq == sk and nk > 1:
        # q chunks aligned to k chunks: q chunk i needs k chunks [0, i]
        n_qc = min(nk, 8)
        if sq % n_qc:
            raise ValueError(f"Sq {sq} is not a multiple of {n_qc} q chunks")
        per = sq // n_qc
        out = torch.cat([run(qg[:, :, :, i * per:(i + 1) * per], i * per,
                             ((i + 1) * per + block_k - 1) // block_k)
                         for i in range(n_qc)], dim=3)
    else:
        out = run(qg, 0, nk)
    return out.reshape(b, hq, sq, d)
