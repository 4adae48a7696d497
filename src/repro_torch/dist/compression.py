"""INT8 error-feedback gradient compression (port of
``repro/dist/compression.py``, the single-process half).

Gradients are quantized to int8 before the data-parallel reduce and the
quantization residual carries to the next step (error feedback): per leaf
``v = g + e``, ``q = quant(v)``, ``e' = v - dequant(q)``, so ``g + e ==
dequant(q) + e'`` and nothing is lost, only deferred.  The quantization is
the datapath's own symmetric absmax int8.

``compressed_psum`` takes ``axis_name=None`` (the identity reduce of one
process, with the wire format's exact numerics); the all-gather mean over a
process group comes with the port's distribution.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.core.quantization import absmax_scale, dequantize, quantize


def init_error(grads: Any) -> Any:
    """Zero error-feedback residuals shaped like ``grads`` (always f32)."""
    return tu.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads)


def compress(grads: Any, error: Any) -> Tuple[Any, Any, Any]:
    """Quantize ``grads + error`` to int8 with per-tensor scales; return
    (payload, scales, error')."""
    v = tu.tree_map(lambda g, e: g.to(torch.float32) + e, grads, error)
    scales = tu.tree_map(absmax_scale, v)
    payload = tu.tree_map(quantize, v, scales)
    new_error = tu.tree_map(lambda x, q, s: x - dequantize(q, s),
                            v, payload, scales)
    return payload, scales, new_error


def decompress(payload: Any, scales: Any) -> Any:
    """Dequantize an int8 payload tree back to f32."""
    return tu.tree_map(dequantize, payload, scales)


def compressed_psum(grads: Any, error: Any, axis_name: Optional[str]
                    ) -> Tuple[Any, Any]:
    """Mean-reduce ``grads`` through the int8 wire format; returns
    ``(reduced, error')``.  With ``axis_name=None`` the reduce is the
    identity: the result is the dequantized payload."""
    if axis_name is not None:
        raise NotImplementedError(
            "compressed_psum over a process group comes with the port's "
            "distribution; pass axis_name=None")
    payload, scales, new_error = compress(grads, error)
    return decompress(payload, scales), new_error
