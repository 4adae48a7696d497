"""Elementary layers (port of ``repro/models/layers.py``).

Parameters are plain dicts of tensors laid out as in the reference (a
linear weight is ``(d_in, d_out)`` and applies as ``x @ w``), so weights
bridge over unchanged.  Compute happens in the config's dtype; norms and
RoPE in float32.

An int8 serve weight (``core.quantization.quantize_weights_for_serving``)
is ``{"w_q", "w_s"}`` in place of ``{"w"}`` and ``{"table_q",
"table_s"}`` in place of ``{"table"}``, its f32 scale ``(1, 1)``.  A
linear dequantizes at use, ``f32(w_q) * w_s`` rounded once to the compute
dtype: the reference's ``w_q.astype(dtype) * w_s`` promotes to f32 because
its scale is an f32 array (a product with the scale cast to bf16 first
would change the bits).  The embedding scales its gathered
rows and the tied head its logits.  On the card a bf16 linear of a few
rows takes the int8 weight to ``kernels/w8_linear.py`` instead
(:func:`w8_kernel_takes`), which computes from the same bits without
writing the dequantized weight; the speculative verify's token slices
keep such a weight int8 too (:func:`dequantized` with ``rows``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import trace
from repro_torch.dist.sharding import current_axis_rules, per_rank, shard
from repro_torch.kernels import w8_linear

Params = Dict[str, torch.Tensor]


def normal_init(gen: torch.Generator, shape, std: float, device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A float32 normal draw times ``std``, cast to ``dtype`` before the
    next leaf is drawn (the serving init keeps no f32 master)."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(std).to(dtype)


def linear_init(gen, d_in: int, d_out: int, *, device,
                std: Optional[float] = None,
                dtype: torch.dtype = torch.float32) -> Params:
    std = std if std is not None else d_in ** -0.5
    return {"w": normal_init(gen, (d_in, d_out), std, device, dtype)}


def linear_weight(params: Params, dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """The weight a linear multiplies: ``w``, or ``w_q`` dequantized,
    ``f32(w_q) * w_s`` rounded once to ``dtype`` (f32 when None), in one
    pass: the int8 payload and the f32 scale promote to f32, and the
    product is stored into a ``dtype`` tensor (3 bytes a parameter in
    bf16).  The dequant is a ``dequant`` span (``repro_torch/trace.py``)."""
    if "w_q" not in params:
        return params["w"]
    w_q = params["w_q"]
    with trace.span("dequant"):
        out = torch.empty(w_q.shape, dtype=dtype or torch.float32,
                          device=w_q.device)
        return torch.mul(w_q, params["w_s"], out=out)


# Rows (tokens) at or under which a bf16 linear over an int8 weight on the
# card runs the w8_linear kernel, which reads the int8 payload once, in
# place of the dequant pass and cuBLAS (PERF.md, the kernel's row sweep).
W8_ROWS = 64


def w8_rows_take(params: Params, rows: int, dtype: Optional[torch.dtype]
                 ) -> bool:
    """Whether :func:`linear_apply` runs ``kernels/w8_linear.py``'s kernel
    on ``rows`` tokens through ``params``: an int8 weight on the card with
    one f32 scale, a bf16 compute dtype, no mesh binding, 1 to ``W8_ROWS``
    rows and a (K, N) the kernel takes."""
    w_q = params.get("w_q")
    if (w_q is None or dtype != torch.bfloat16 or not w_q.is_cuda
            or current_axis_rules() is not None):
        return False
    w_s = params["w_s"]
    return (tuple(w_s.shape) == (1, 1) and w_s.dtype == torch.float32
            and 0 < rows <= W8_ROWS and w_q.dim() == 2
            and w8_linear.takes(*w_q.shape))


def w8_kernel_takes(params: Params, x: torch.Tensor,
                    dtype: Optional[torch.dtype]) -> bool:
    """:func:`w8_rows_take` for ``x (..., K)`` on the card.  It reads only
    what the call can observe."""
    w_q = params.get("w_q")
    return (w_q is not None and x.is_cuda and x.shape[-1] == w_q.shape[0]
            and w8_rows_take(params, x.numel() // w_q.shape[0], dtype))


def linear_apply(params: Params, x: torch.Tensor, *,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if w8_kernel_takes(params, x, dtype):
        return w8_linear.launch(x.to(dtype), params["w_q"], params["w_s"])
    w = linear_weight(params, dtype)
    if dtype is not None:
        w = w.to(dtype)
        x = x.to(dtype)
    return x @ w


def split_linear_apply(params: Params, x: torch.Tensor, sizes, *,
                       dtype: Optional[torch.dtype] = None):
    """``linear_apply`` with its output split into parts of ``sizes`` along
    the last dim.  On a mesh the weight is split first and each part laid
    out over its own output columns ("mlp"), so each rank multiplies its
    own columns of every part: a weight whose output dim is split across
    ranks at other boundaries than the parts' would have DTensor gather
    the product, and its weight gradient, whole on every rank."""
    if current_axis_rules() is None:
        return torch.split(linear_apply(params, x, dtype=dtype), sizes,
                           dim=-1)
    w = linear_weight(params, dtype)
    return tuple(linear_apply({"w": shard(part, None, "mlp")}, x,
                              dtype=dtype)
                 for part in torch.split(w, sizes, dim=-1))


def dequantized(tree, dtype: Optional[torch.dtype] = None,
                rows: Optional[int] = None):
    """``tree`` with each int8 linear weight made float once
    (``{"w": linear_weight(p, dtype)}``) and each int8 table's payload cast
    to ``dtype`` (f32 if None; its scale kept), for a caller that applies
    them several times (``per_token``): the values every use would
    compute.  With ``rows``, an int8 weight that :func:`linear_apply` reads
    through the w8_linear kernel at that many rows (:func:`w8_rows_take`)
    stays int8: the decode step reads it so at its B rows, and the
    verify's (B, 1) token slices then compute the decode step's bits."""
    if not isinstance(tree, dict):
        return tree
    if "w_q" in tree:
        if rows is not None and w8_rows_take(tree, rows, dtype):
            return tree
        return {"w": linear_weight(tree, dtype)}
    if "table_q" in tree:
        return {"table_q": tree["table_q"].to(dtype or torch.float32),
                "table_s": tree["table_s"]}
    return {k: dequantized(v, dtype, rows) for k, v in tree.items()}


def per_token(fn, x: torch.Tensor):
    """``fn`` on each token's contiguous (B, 1, ...) slice of ``x (B, T,
    ...)``, its output (a tensor or a tuple of them) concatenated on the
    token axis.  On the card a float reduction (an f32 mean or GEMM, a bf16
    GEMM with a long K) may sum in an order chosen by the row count, so the
    speculative verify runs such stages at the decode step's shape."""
    outs = [fn(x[:, i:i + 1].contiguous()) for i in range(x.shape[1])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return torch.cat(outs, dim=1)


def rmsnorm_init(dim: int, device) -> Params:
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device)}


def rmsnorm_apply(params: Params, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    # on a mesh the mean square and its cotangent are reduced while small:
    # a partial one would meet a split feature dim in the backward and
    # have DTensor gather the features whole
    var = shard(torch.mean(torch.square(xf), dim=-1, keepdim=True),
                "batch", *[None] * (x.dim() - 1))
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(dt)


def layernorm_init(dim: int, device) -> Params:
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device),
            "bias": torch.zeros(dim, dtype=torch.float32, device=device)}


def layernorm_apply(params: Params, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """LayerNorm with an f32 affine.  The variance is the population
    variance (``jnp.var``), not torch's default ``correction=1``."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


def nonparam_layernorm_apply(params: Params, x: torch.Tensor,
                             eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: normalize only, no affine.  The
    variance is the population variance (``jnp.var``), not torch's
    default ``correction=1``."""
    del params
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt)


# norm kind -> (init(dim, device), apply(params, x)); a non-parametric
# norm's parameters are the empty dict
NORM_INIT = {"rmsnorm": rmsnorm_init, "layernorm": layernorm_init,
             "nonparam_ln": lambda dim, device: {}}
NORM_APPLY = {"rmsnorm": rmsnorm_apply, "layernorm": layernorm_apply,
              "nonparam_ln": nonparam_layernorm_apply}


def pad_vocab(vocab_size: int, multiple: int = 256) -> int:
    """Round the vocab up to a multiple (logits over padding are computed
    like any other lane)."""
    return ((vocab_size + multiple - 1) // multiple) * multiple


def embedding_init(gen, vocab_padded: int, dim: int, *, device,
                   std: float = 0.02,
                   dtype: torch.dtype = torch.float32) -> Params:
    return {"table": normal_init(gen, (vocab_padded, dim), std, device,
                                 dtype)}


class _EmbeddingGather(torch.autograd.Function):
    """``table[ids]`` whose backward is deterministic on the card: the rows'
    gradient is the product ``onehot(ids)^T @ g`` (each output row's sum in
    one GEMM's fixed order), not a scatter-add, whose CUDA path may add the
    rows of a repeated token in any order."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        n = flat.numel()
        onehot = torch.zeros((n, ctx.vocab), dtype=g.dtype, device=g.device)
        onehot[torch.arange(n, device=g.device), flat] = 1
        return onehot.T @ g.reshape(n, -1), None


class _MeshEmbeddingGather(torch.autograd.Function):
    """:class:`_EmbeddingGather` on a mesh, for a table whose vocab dim is
    split over some mesh dims and ids whose rows are split over others.
    The forward moves the fewer bytes of two ways: each rank gathers its
    ids' rows from the whole table (an all-gather of the table), or from
    its own vocab rows, zeros elsewhere, and the rows' partial sums are
    reduced (one nonzero term each, so exact): a decode step's few rows
    against a training batch's many.  The backward's one-hot product runs
    over the rank's own vocab rows only, so the table's gradient comes out
    split over the vocab as the table is (partial over the ids' mesh
    dims), where a whole table's product would repeat every row's sum on
    each rank of the vocab's mesh dims."""

    @staticmethod
    def forward(ctx, table, ids, lo: int, hi: int):
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh = table.device_mesh
        ids_local = ids.to_local()
        ctx.save_for_backward(ids_local)
        ctx.meta = (mesh, table.placements, ids.placements, lo, hi)
        tab = table.to_local()
        if ids_local.numel() >= table.shape[0]:
            whole = table.redistribute(mesh, [Replicate()] * mesh.ndim)
            return DTensor.from_local(whole.to_local()[ids_local], mesh,
                                      ids.placements, run_check=False)
        inside = (ids_local >= lo) & (ids_local < hi)
        rows = torch.where(inside[..., None],
                           tab[torch.where(inside, ids_local - lo, 0)], 0.0)
        part = [Partial() if p == Shard(0) else q
                for p, q in zip(table.placements, ids.placements)]
        return DTensor.from_local(rows, mesh, part, run_check=False
                                  ).redistribute(mesh, ids.placements)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        (ids,) = ctx.saved_tensors
        mesh, tab_pl, ids_pl, lo, hi = ctx.meta
        g = g.redistribute(mesh, ids_pl).to_local()
        flat = ids.reshape(-1)
        onehot = (flat[:, None] == torch.arange(lo, hi, device=g.device)
                  ).to(g.dtype)
        grad = onehot.T @ g.reshape(flat.numel(), -1)
        pl = [Shard(0) if p == Shard(0) else
              Partial() if isinstance(q, Shard) else Replicate()
              for p, q in zip(tab_pl, ids_pl)]
        return (DTensor.from_local(grad, mesh, pl, run_check=False), None,
                None, None)


def _vocab_rows(table, ids):
    """This rank's vocab rows ``[lo, hi)`` of a DTensor ``table`` split
    evenly over the mesh dims where its placement is ``Shard(0)`` (and
    whole on the others), or None where the split is uneven, meets the
    ids' split on a mesh dim, or splits the table's other dim."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i, (p, q) in enumerate(zip(table.placements, ids.placements)):
        if p not in (Shard(0), Replicate()):
            return None
        if p == Shard(0):
            if isinstance(q, Shard):
                return None
            idx = idx * mesh.size(i) + coord[i]
            n *= mesh.size(i)
    if table.shape[0] % n:
        return None
    rows = table.shape[0] // n
    return idx * rows, (idx + 1) * rows


def _embed_table(params: Params):
    """(table, None), or an int8 table's (payload, scale)."""
    if "table_q" in params:
        return params["table_q"], params["table_s"]
    return params["table"], None


def param_device(params) -> torch.device:
    """The device a model's parameters live on: its embedding table's."""
    return _embed_table(params["embed"])[0].device


def embedding_apply(params: Params, token_ids: torch.Tensor, *,
                    dtype: torch.dtype) -> torch.Tensor:
    """The rows of ``token_ids`` in ``dtype``; an int8 table's rows are
    cast, then multiplied by its scale cast to ``dtype``."""
    tab, sc = _embed_table(params)
    tab = shard(tab, "vocab", "embed")
    ids = token_ids.long()
    # on a mesh each rank gathers its own rows from the whole table
    # (DTensor's gather strategies do not cover every placement of ids)
    span = (_vocab_rows(tab, ids) if sc is None and hasattr(tab, "placements")
            and hasattr(ids, "placements") else None)
    if span is not None:
        rows = _MeshEmbeddingGather.apply(tab, ids, *span)
    else:
        gather = _EmbeddingGather.apply if sc is None else (
            lambda t, i: t[i])
        rows = per_rank(gather, ids, (tab, ids), ({}, {0: 0}), {0: 0})
    return rows.to(dtype) if sc is None else rows.to(dtype) * sc.to(dtype)


def unembed_apply(params: Params, x: torch.Tensor, *,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Tied unembedding: ``x (B, S, d)`` against the embedding table ->
    logits over the padded vocab, in ``dtype`` (f32, the reference's
    default: the table is multiplied as stored, f32 when served); an int8
    table's logits are then multiplied by its scale in ``dtype``."""
    tab, sc = _embed_table(params)
    tab = shard(tab, "vocab", "embed")
    logits = x.to(dtype) @ tab.to(dtype).T
    return logits if sc is None else logits * sc.to(dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, H, S, D); positions: (S,) shared or (B, S) ragged."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # (D/2,)
    pos = positions.to(torch.float32)
    if positions.dim() == 1:                                  # (S,)
        angles = pos[None, None, :, None] * freqs
    else:                                                     # (B, S)
        angles = pos[:, None, :, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)           # (B|1,1,S,D/2)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
