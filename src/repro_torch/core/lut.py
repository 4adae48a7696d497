"""LUT construction and reads for CIMple's split softmax (port of
``repro/core/lut.py``).

* exp LUT ``E``: 256 entries indexed by ``z_q + 128``,
  ``E[z_q] = round(exp((z_q - 127) * s_z) * 2^f_e)`` — the int8 ceiling
  ``z_quant_max = 127`` replaces the row max, so no max pass is needed.
* reciprocal LUT ``M``: ``1/S`` of the accumulated denominator from the top
  ``recip_index_bits`` mantissa bits of ``S``, one multiply plus a power of
  two in place of the division.

The table builders are numpy (host constants), copied verbatim so both
packages build identical tables.  The reciprocal index and ``2^e`` are read
from f32 *bit patterns*: float ``log2``/``exp2`` can be an ulp off even at
powers of two, which flips the table index at bin boundaries.

The reference's two kernel options live here too: ``lut_mode="compute"``
(:func:`build_exp_lut_compute`, the exp recomputed in f32 instead of the
f64-built table) and ``exact_recip`` (:func:`recip_factor`, a division in
place of the reciprocal LUT).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import per_rank

Z_QUANT_MAX = 127  # top of the symmetric int8 domain — replaces the row max

EXP_FRAC_BITS = 15     # exp LUT entries in [0, 2^15]
RECIP_FRAC_BITS = 15   # reciprocal mantissa table entries in (2^14, 2^15]


@dataclasses.dataclass(frozen=True)
class LUTConfig:
    """Static configuration of the split-softmax LUT pair."""
    scale_z: float                  # attention-score quantization scale s_z
    exp_frac_bits: int = EXP_FRAC_BITS
    recip_index_bits: int = 8       # mantissa bits indexing the recip table
    recip_frac_bits: int = RECIP_FRAC_BITS

    @property
    def recip_table_size(self) -> int:
        return 1 << self.recip_index_bits

    @property
    def lut_bytes(self) -> int:
        """Total LUT footprint: 256 exp and the reciprocal entries, 4 bytes
        each."""
        return 4 * (256 + self.recip_table_size)


def build_exp_lut(cfg: LUTConfig) -> np.ndarray:
    """256-entry exp table, indexed by ``z_q + 128``; index 255 is 2^f_e."""
    idx = np.arange(256, dtype=np.float64)
    z = idx - 128.0 - float(Z_QUANT_MAX)          # z_q - z_quant_max in [-255, 0]
    vals = np.round(np.exp(z * cfg.scale_z) * (1 << cfg.exp_frac_bits))
    return vals.astype(np.int32)


def build_exp_lut_compute(cfg: LUTConfig) -> torch.Tensor:
    """The reference's ``lut_mode="compute"`` exp as a 256-entry int32
    table (CPU), indexed like :func:`build_exp_lut`:
    ``round(exp(f32(z_q - 127) * f32(s_z)) * 2^f_e)`` in f32, rounded half
    to even, ``s_z`` cast to f32 first as JAX does with the weak-typed
    float.

    The reference's kernels compute that formula per element.  ``e``
    depends on ``z_q`` alone, and ``z_q`` takes only the 256 values
    -128..127, so a table of the formula's values is the same function;
    the one-hot matmul read and the per-element recompute are TPU layout
    choices.  The card reads this CPU-built table, so card and CPU agree bit
    for bit.  Against the reference it holds within 1 LSB of ``e``: XLA's
    and torch's f32 ``exp`` may differ by an ulp, which can flip a rounding.
    Every entry is at most ``2^f_e``."""
    z = torch.arange(-128, 128, dtype=torch.int32) - Z_QUANT_MAX
    arg = z.to(torch.float32) * torch.tensor(cfg.scale_z, dtype=torch.float32)
    e = torch.round(torch.exp(arg) * float(1 << cfg.exp_frac_bits))
    return e.to(torch.int32)


def build_recip_lut(cfg: LUTConfig) -> np.ndarray:
    """2^m-entry reciprocal-mantissa table,
    ``M[i] = round(2^f_m / (1 + (i + 0.5) / 2^m))``."""
    m = cfg.recip_index_bits
    i = np.arange(1 << m, dtype=np.float64)
    mant = 1.0 + (i + 0.5) / (1 << m)
    vals = np.round((1 << cfg.recip_frac_bits) / mant)
    return vals.astype(np.int32)


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``; on a mesh each rank reads its own block of ``idx``
    (DTensor's gather strategies do not cover every placement of the
    indices)."""
    every = {d: d for d in range(idx.dim())}
    return per_rank(lambda i: table[i], idx, (idx,), (every,), every)


def exp_lookup(z_q: torch.Tensor, exp_lut: torch.Tensor) -> torch.Tensor:
    """E[z_q] — int8 scores -> int32 fixed-point exponentials."""
    return _lookup(exp_lut, z_q.long() + 128)


def exp_lookup_onehot(z_q: torch.Tensor, exp_lut: torch.Tensor
                      ) -> torch.Tensor:
    """The reference's MXU-shaped read, ``one_hot(z_q + 128) @ table`` in
    f32: equal to :func:`exp_lookup` bit for bit (each row picks one entry
    of at most 2^15, exact in f32; on the card with TF32 off, as
    ``repro_torch.resolve_device`` sets it)."""
    onehot = torch.nn.functional.one_hot(z_q.long() + 128, 256)
    return (onehot.to(torch.float32)
            @ exp_lut.to(torch.float32)).to(torch.int32)


def recip_mantissa_index(s: torch.Tensor, mbits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(idx, expo)`` with ``max(s, 1) = (1 + frac) * 2^expo`` and ``idx``
    the top ``mbits`` bits of ``frac``, read from the IEEE-754 f32 bits."""
    s_f = torch.clamp_min(s.to(torch.float32), 1.0)
    bits = s_f.view(torch.int32)
    expo = torch.bitwise_and(bits >> 23, 0xFF) - 127
    idx = torch.bitwise_and(bits >> (23 - mbits), (1 << mbits) - 1)
    return idx, expo


def recip_lookup(s: torch.Tensor, recip_lut: torch.Tensor, cfg: LUTConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(r, e)`` with ``1/s ~= r * 2^e`` (``r`` int32 table value)."""
    idx, expo = recip_mantissa_index(s, cfg.recip_index_bits)
    r = _lookup(recip_lut, idx.long())
    e = -expo - cfg.recip_frac_bits
    return r, e


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for integer e in [-126, 127], by building the f32 bits."""
    bits = (e.to(torch.int32) + 127) << 23
    return bits.view(torch.float32)


def recip_factor(s: torch.Tensor, recip_lut: torch.Tensor, cfg: LUTConfig,
                 exact_recip: bool = False) -> torch.Tensor:
    """The f32 factor ``1/max(s, 1)`` of the split softmax's finalize: the
    reciprocal LUT's ``r * 2^e``, or with ``exact_recip`` the correctly
    rounded f32 quotient (the reference's ``1.0 / s``), formed in f64 and
    rounded once: a correctly rounded f64 quotient rounds to the correctly
    rounded f32 one (53 >= 2 * 24 + 2 bits), on any device and whatever its
    division's fast paths."""
    s = torch.clamp_min(s.to(torch.float32), 1.0)
    if exact_recip:
        return (1.0 / s.to(torch.float64)).to(torch.float32)
    r, ex = recip_lookup(s, recip_lut, cfg)
    return r.to(torch.float32) * exp2_int(ex)


def recip_apply(x: torch.Tensor, r: torch.Tensor, e: torch.Tensor
                ) -> torch.Tensor:
    """x / s  ~=  x * r * 2^e   (float32 result)."""
    return x.to(torch.float32) * r.to(torch.float32) * exp2_int(e)


def recip_float(s: torch.Tensor, recip_lut: torch.Tensor, cfg: LUTConfig
                ) -> torch.Tensor:
    """The LUT's 1/s as f32, ``r * exp2(e)`` with a float ``exp2`` as the
    reference's convenience has it (:func:`recip_factor` builds the power
    of two from its bits)."""
    r, e = recip_lookup(s, recip_lut, cfg)
    return r.to(torch.float32) * torch.exp2(e.to(torch.float32))
