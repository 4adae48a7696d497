"""ArchSpec: architecture + shape grid + dry-run input specs (port of
``repro/configs/base.py``).

The four assigned LM shapes:
  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> serve prefill
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 token, KV 32k)
  long_500k    seq 524,288 global_batch 1     -> serve_step; SUB-QUADRATIC
               attention required: runs only for ssm/hybrid/SWA archs.

The input and cache specs are tensors on the ``meta`` device: shapes and
dtypes, no storage (the counterpart of ``jax.ShapeDtypeStruct``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs_for(cfg: ModelConfig, cell: ShapeCell
                    ) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of ``cell`` under
    ``cfg``."""
    b, s = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cell.kind == "decode":
        # one (decoder) token vs caches of length s
        return {"token": _spec((b,), i32)}
    out = {"tokens": _spec((b, s), i32)}
    if cfg.family == "encdec":
        out = {"frames": _spec((b, s, cfg.d_model), cfg.compute_dtype),
               **out}
    if cell.kind == "train":
        out["labels"] = _spec((b, s), i32)
    return out


def cache_specs_for(cfg: ModelConfig, cell: ShapeCell, cache_len: int
                    ) -> Optional[Dict]:
    """The decode cache of a decode ``cell`` under ``cfg`` on ``meta``
    (``cache_len`` positions; the encoder-decoder's cross K/V hold 4096
    encoder positions); None for another kind."""
    if cell.kind != "decode":
        return None
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T
    if cfg.family == "encdec":
        return E.make_cache(cfg, cell.global_batch, cache_len, 4096,
                            device="meta")
    return T.make_cache(cfg, cell.global_batch, cache_len, device="meta")


def cache_len_for(cfg: ModelConfig, cell: ShapeCell) -> int:
    """KV cache allocation length.  SWA archs use a *ring buffer* of
    exactly ``window`` slots (window must be 128-aligned): it always holds
    precisely the attendable positions, so decode needs no window mask and
    the 500k cell stays sub-quadratic in both compute and memory."""
    if cfg.window is not None:
        assert cfg.window % 128 == 0, cfg.window
        return min(cell.seq_len, cfg.window)
    return cell.seq_len


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    smoke: ModelConfig                       # reduced same-family config
    skip_shapes: Dict[str, str] = dataclasses.field(default_factory=dict)
    source: str = ""                         # citation tag

    @property
    def name(self) -> str:
        return self.config.name

    def shapes(self):
        return {k: v for k, v in SHAPES.items() if k not in self.skip_shapes}

    # ---------------- dry-run input specs (no allocation) -----------------
    def input_specs(self, shape_name: str) -> Dict[str, torch.Tensor]:
        """``meta`` stand-ins for every model input of this cell."""
        return input_specs_for(self.config, SHAPES[shape_name])

    def cache_specs(self, shape_name: str) -> Optional[Dict]:
        """The decode cache of a decode cell, on ``meta``; None otherwise."""
        cell = SHAPES[shape_name]
        return cache_specs_for(self.config, cell, self.cache_len(cell))

    def cache_len(self, cell: ShapeCell) -> int:
        return cache_len_for(self.config, cell)
