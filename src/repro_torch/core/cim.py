"""Behavioral and capacity model of the CIMple CIM core (port of
``repro/core/cim.py``).

The silicon: a 32 kb standard-cell SRAM CIM macro, 32 partitions, each
holding two 512-bit dual-banked blocks.  Weights are stored nibble-split
(the top half of the array holds the 4 MSBs, the bottom half the 4 LSBs),
and an 8b x 8b MAC is two 4b MACs with the MSB partial product shifted left
by 4 before the sum, its partial products accumulated over 8 cycles.

* :func:`nibble_split_matmul` emulates the dual-bank MSB/LSB shift-add
  datapath and :func:`serial_bit_matmul` the 8-cycle bit-serial one; each
  is bit-exact with the direct int32 GEMM.  Every nibble (``[-8, 7]``,
  ``[0, 15]``) and input bit (``{0, 1}``) fits int8, so each partial
  product is an int8 GEMM through ``kernels/ops`` (kernel 8 on the card,
  its plain version on the CPU): 2 GEMMs for the nibble split, 8 on one
  K-major packing of ``w`` for the bit-serial form.  The shift-add stays
  in int32.
* :class:`CIMConfig` is the capacity and geometry model (how many tile
  loads and cycles a GEMM of a given shape needs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.kernels import ops


def nibble_split_weights(w_q: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed int8 weights -> (signed MSB nibble, unsigned LSB nibble),
    int32: ``w = w_msb * 16 + w_lsb`` with ``w_msb`` in [-8, 7] (an
    arithmetic shift) and ``w_lsb`` in [0, 15]."""
    w = w_q.to(torch.int32)
    return w >> 4, w & 0xF


def _rows(x_q: torch.Tensor) -> torch.Tensor:
    """``x_q (..., K)`` as the GEMM's 2-D ``(M, K)`` operand."""
    return x_q.reshape(-1, x_q.shape[-1])


def nibble_split_matmul(x_q: torch.Tensor, w_q: torch.Tensor
                        ) -> torch.Tensor:
    """int8 ``x_q (..., K)`` @ int8 ``w_q (K, N)`` through the dual 4-bit
    banks: ``(x @ w_msb) << 4 + x @ w_lsb`` in int32, equal to the direct
    int32 product."""
    w_msb, w_lsb = nibble_split_weights(w_q)
    x = _rows(x_q)
    acc_msb = ops.int8_matmul(x, w_msb.to(torch.int8))
    acc_lsb = ops.int8_matmul(x, w_lsb.to(torch.int8))
    return ((acc_msb << 4) + acc_lsb).reshape(x_q.shape[:-1] + (-1,))


def serial_bit_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The 8-cycle bit-serial accumulation: cycle b adds ``bit_b(x) @ w <<
    b``, and bit 7, two's complement's sign bit, subtracts.  Equal to the
    direct int32 product."""
    x = _rows(x_q)
    bits = [(x >> b) & 1 for b in range(8)]
    acc = torch.zeros((x.shape[0], w_q.shape[-1]), dtype=torch.int32,
                      device=x.device)
    for b, prod in enumerate(ops.int8_matmul_shared_w(bits, w_q)):
        contrib = prod << b
        acc = acc - contrib if b == 7 else acc + contrib
    return acc.reshape(x_q.shape[:-1] + (-1,))


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """Geometry of the CIMple macro as implemented in the paper (28 nm
    FD-SOI)."""
    sram_kbits: int = 32            # CIM array size
    partitions: int = 32            # CIM core partitions
    block_bits: int = 512           # per-SRAM-block capacity (x2 banks)
    input_bus_bits: int = 64
    write_bus_bits: int = 128
    weight_bits: int = 8
    act_bits: int = 8
    acc_bits: int = 32
    global_buffer_kbits: int = 16 * 8   # 16 kB global SRAM buffer
    freq_mhz: float = 417.0             # 0.85 V operating point
    mac_cycles: int = 8                 # 8-cycle bit-serial accumulation

    @property
    def weights_resident(self) -> int:
        """int8 weights resident in the array at once."""
        return self.sram_kbits * 1024 // self.weight_bits

    @property
    def macs_per_cycle(self) -> int:
        """Peak parallel 1b-partial MACs per cycle across partitions: one
        bank of 64 weights active per partition and read."""
        return self.partitions * (self.block_bits // self.weight_bits)

    @property
    def peak_ops_per_cycle(self) -> int:
        """1 op = 1 multiply or 1 add; an 8b MAC is 2 ops, completed every
        ``mac_cycles`` cycles a lane."""
        return 2 * self.macs_per_cycle // self.mac_cycles

    @property
    def peak_tops(self) -> float:
        return self.peak_ops_per_cycle * self.freq_mhz * 1e6 / 1e12

    def gemm_tiles(self, m: int, k: int, n: int) -> int:
        """Weight-tile loads of an (m,k)x(k,n) GEMM: the (k x n) panel in
        ``ceil(k*n / weights_resident)`` loads, each streamed over the m
        activations."""
        return math.ceil(k * n / self.weights_resident)

    def gemm_cycles(self, m: int, k: int, n: int,
                    act_sparsity: float = 0.0) -> float:
        """Cycles of a GEMM at an activation sparsity, which removes
        computed MACs (no bit-skipping hardware)."""
        macs = m * k * n * (1.0 - act_sparsity)
        return macs * self.mac_cycles / self.macs_per_cycle
