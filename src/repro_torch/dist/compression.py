"""INT8 error-feedback gradient compression (port of
``repro/dist/compression.py``).

Gradients are quantized to int8 before the data-parallel reduce and the
quantization residual carries to the next step (error feedback): per leaf
``v = g + e``, ``q = quant(v)``, ``e' = v - dequant(q)``, so ``g + e ==
dequant(q) + e'`` and nothing is lost, only deferred.  The quantization is
the datapath's own symmetric absmax int8.

``compressed_psum`` takes ``axis_name=None`` (the identity reduce of one
process, with the wire format's exact numerics) or a process group (or the
name of a dim of the bound mesh, ``dist.sharding.axis_rules``): the int8
payload and the f32 scales are all-gathered over it — int8 is what crosses
the wire, 4x less than a float all-reduce — then dequantized and averaged
locally.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

from repro_torch import tree as tu
from repro_torch.core.quantization import absmax_scale, dequantize, quantize


def init_error(grads: Any) -> Any:
    """Zero error-feedback residuals shaped like ``grads`` (always f32)."""
    return tu.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads)


def compress(grads: Any, error: Any, *, fused: bool = False
             ) -> Tuple[Any, Any, Any]:
    """Quantize ``grads + error`` to int8 with per-tensor scales; return
    (payload, scales, error').  ``fused`` rounds ``e' = v - q * s`` once
    (a fused multiply-add, exact in f64), as the reference's compiled
    reduce computes it; otherwise the product is rounded first, as its
    op-by-op execution does."""
    v = tu.tree_map(lambda g, e: g.to(torch.float32) + e, grads, error)
    scales = tu.tree_map(absmax_scale, v)
    payload = tu.tree_map(quantize, v, scales)
    if fused:
        def residual(x, q, s):
            return (x.to(torch.float64) - q.to(torch.float64)
                    * s.to(torch.float64)).to(torch.float32)
    else:
        def residual(x, q, s):
            return x - dequantize(q, s)
    new_error = tu.tree_map(residual, v, payload, scales)
    return payload, scales, new_error


def decompress(payload: Any, scales: Any) -> Any:
    """Dequantize an int8 payload tree back to f32."""
    return tu.tree_map(dequantize, payload, scales)


def _group(axis_name):
    """A process group, or the group of the bound mesh's dim so named."""
    if not isinstance(axis_name, str):
        return axis_name
    from repro_torch.dist.sharding import current_axis_rules
    env = current_axis_rules()
    if env is None:
        raise ValueError(f"axis {axis_name!r} names a mesh dim, but no mesh "
                         f"is bound (dist.sharding.axis_rules)")
    return env[0].get_group(axis_name)


def _gathered_mean(q: torch.Tensor, s: torch.Tensor, group) -> torch.Tensor:
    """All-gather the int8 payload and its scale over ``group``;
    dequantize and mean locally, in rank order.  Each product after the
    first is added to the running sum with one rounding (a fused
    multiply-add, as XLA's reduction of the reference contracts it): f64
    holds an int8 x f32 product exactly."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    qg = [torch.empty_like(q) for _ in range(n)]
    sg = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qg, q.contiguous(), group=group)     # n x int8
    dist.all_gather(sg, s.contiguous(), group=group)     # n x f32 scalar
    acc = qg[0].to(torch.float32) * sg[0]
    for qi, si in zip(qg[1:], sg[1:]):
        acc = (qi.to(torch.float64) * si.to(torch.float64)
               + acc.to(torch.float64)).to(torch.float32)
    return acc / n


def compressed_psum(grads: Any, error: Any, axis_name: Union[None, str, Any]
                    ) -> Tuple[Any, Any]:
    """Mean-reduce ``grads`` over ``axis_name`` through the int8 wire
    format; returns ``(reduced, error')``.  ``error'`` is the *local*
    residual: each participant keeps its own feedback state.  With
    ``axis_name=None`` the reduce is the identity: the result is the
    dequantized payload.  The group path rounds as the reference's
    compiled ``pmap``/``shard_map`` reduce does (``compress(fused=True)``,
    :func:`_gathered_mean`); the identity path as its op-by-op run."""
    if axis_name is None:
        payload, scales, new_error = compress(grads, error)
        return decompress(payload, scales), new_error
    group = _group(axis_name)
    payload, scales, new_error = compress(grads, error, fused=True)
    reduced = tu.tree_map(lambda q, s: _gathered_mean(q, s, group),
                          payload, scales)
    return reduced, new_error
