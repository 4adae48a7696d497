"""Distributed sharding: logical-axis annotations and the param / batch /
cache rules (port of ``repro/dist/sharding.py`` onto ``torch.distributed``'s
``DeviceMesh`` and DTensor).

Two layers live here, as in the reference:

1. **Logical-axis API** (``shard``, ``axis_rules``) — what the model code
   calls.  Model files annotate activations with *logical* axis names
   (``"batch"``, ``"heads"``, ``"mlp"``, ``"vocab"``, ``"expert"``,
   ``"embed"``, ``"seq"``); the launcher binds those names to mesh axes
   with ``axis_rules(mesh, rules)``.  Outside any binding ``shard`` is the
   identity and returns its argument, so the same model code runs
   unchanged on one device.  Inside a binding a DTensor argument is
   redistributed to the guarded placements (the counterpart of
   ``with_sharding_constraint``); a plain tensor passes through, since
   there is no mesh placement to constrain.

2. **Path-pattern parameter / state rules** (``param_shardings``,
   ``batch_shardings``, ``cache_shardings``) — FSDP over ``data``, TP/EP
   over ``model``, pure data parallelism over ``pod``; decode caches shard
   the batch over the data axes and the dense sequence over ``model``.
   Each returns, per leaf, a *spec*: a tuple with one entry per tensor dim,
   ``None`` (replicated), a mesh-axis name, or a tuple of them (the dim is
   sharded over their product) — the counterpart of a ``PartitionSpec``.
   :func:`placements` turns a spec into DTensor ``Placement``\\ s on a
   ``DeviceMesh`` and :func:`place` / :func:`place_tree` distribute
   tensors by it.

The rules match a path's trailing components and the leaf's trailing dims,
so they apply to the reference's stacked layer segments (whose leading
layer axes get ``None``) and to the port's per-layer lists alike: the port
holds each layer's leaves unstacked, so its specs are the reference's with
the stacked axes dropped.

A "mesh" here is a ``DeviceMesh`` built with ``mesh_dim_names``, or, for
the spec functions, any stand-in with a ``shape`` dict of axis sizes (the
reference's tests' ``FakeMesh``): they run without a process group.
"""
from __future__ import annotations

import contextlib
import functools
import re
import threading
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple, Union

import torch

from repro_torch import tree as tu

if TYPE_CHECKING:
    from repro_torch.models.config import ModelConfig

AxisBinding = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Any, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a stand-in with a
    ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that shard the batch (all data-parallel axes)."""
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


# ---------------------------------------------------------------------------
# logical-axis annotation API
# ---------------------------------------------------------------------------

# One binding per thread: a server thread's serve-mesh binding must not leak
# into a concurrent trainer's step.
_BINDING = threading.local()


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, AxisBinding]):
    """Bind logical activation axes to mesh axes for the enclosed code.

    ``rules`` maps a logical name to a mesh axis name, a tuple of them (the
    dim is sharded over their product, e.g. ``("pod", "data")`` for the
    global batch) or ``None`` (replicate); names missing from ``rules``
    replicate.  ``mesh=None`` disables annotation.
    """
    prev = getattr(_BINDING, "env", None)
    _BINDING.env = None if mesh is None else (mesh, dict(rules))
    try:
        yield
    finally:
        _BINDING.env = prev


def current_axis_rules() -> Optional[Tuple[Any, Dict[str, AxisBinding]]]:
    """The active ``(mesh, rules)`` binding, or None."""
    return getattr(_BINDING, "env", None)


def _mesh_axes_of(binding: AxisBinding) -> Tuple[str, ...]:
    if binding is None:
        return ()
    if isinstance(binding, str):
        return (binding,)
    return tuple(binding)


def _logical_spec(shape, logical_axes, mesh,
                  rules: Dict[str, AxisBinding]) -> Spec:
    """The guarded spec ``shard`` constrains an array of ``shape`` to: a
    mesh axis is used at most once per array (first dim wins), and any dim
    the bound axes do not divide replicates."""
    sizes = mesh_axes(mesh)
    used: set = set()
    spec = []
    for dim_size, name in zip(shape, logical_axes):
        axes = _mesh_axes_of(rules.get(name)) if name is not None else ()
        axes = tuple(a for a in axes if a in sizes)
        total = 1
        for a in axes:
            total *= sizes[a]
        if (not axes or any(a in used for a in axes)
                or dim_size % total != 0):
            spec.append(None)
            continue
        used.update(axes)
        spec.append(axes[0] if len(axes) == 1 else axes)
    return tuple(spec)


def shard(x: torch.Tensor, *logical_axes: Optional[str],
          sizes: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Constrain ``x``'s placement by logical axis names; the identity (the
    same object) when no ``axis_rules`` binding is active.

    One name (or None) per dim.  Under a binding a DTensor is
    redistributed to :func:`_logical_spec`'s placements (a no-op when it is
    already there); a plain tensor is returned as it is.  ``sizes`` are the
    dim sizes the divisibility guard tests, default ``x``'s own (a flat
    ``(B, S, n * hd)`` projection about to be split into ``n`` heads
    guards on ``n``, so that each rank holds whole heads).
    """
    env = current_axis_rules()
    if env is None:
        return x
    mesh, rules = env
    if len(logical_axes) != x.dim():
        raise ValueError(
            f"shard() got {len(logical_axes)} logical axes for a rank-"
            f"{x.dim()} tensor: {logical_axes} vs shape {tuple(x.shape)}")
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(_logical_spec(sizes or x.shape, logical_axes, mesh,
                                    rules), x.device_mesh)
    return _Constrain.apply(x, want)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``want``, and its gradient too: the
    constraint holds for the cotangent as it does for the value (a
    sharding constraint's transpose is the same constraint).  Without it a
    gradient summed from a residual and a row-parallel branch stays
    partial, and DTensor gathers the next weight whole rather than reduce
    it, repeating that product on every rank of the axis."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.want:
            return g, None
        return g.redistribute(g.device_mesh, ctx.want), None


_KEPT = threading.local()


@contextlib.contextmanager
def kept_for_backward():
    """Collectives issued inside are saved by :func:`remat_context`'s
    checkpoint, so the recompute of a checkpointed block reuses their
    results instead of issuing them again."""
    prev = getattr(_KEPT, "on", False)
    _KEPT.on = True
    try:
        yield
    finally:
        _KEPT.on = prev


def remat_context():
    """A ``context_fn`` for ``torch.utils.checkpoint`` that saves the
    results of the collectives issued under :func:`kept_for_backward` and
    recomputes every other op; None (plain recompute) without a mesh
    binding, which issues no collective."""
    if current_axis_rules() is None:
        return None
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, func, *args, **kwargs):
        if (getattr(_KEPT, "on", False)
                and func.namespace == "_c10d_functional"
                and func.overloadpacket.__name__ != "wait_tensor"):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def per_rank(fn, template, args, maps, out_maps):
    """``fn(*args)`` run on each rank's local blocks, for a function that
    is independent across some dims (a batch, heads).

    ``template`` is a DTensor whose placements name, for each mesh dim,
    the template dim split over it (``Shard(d)``) or none.  ``maps[i]``
    maps template dims to dims of ``args[i]`` (``{0: 0, 1: 1}``: batch and
    heads where they are); a mesh dim whose template dim an arg lacks
    leaves that arg whole on it.  ``None`` passes a non-DTensor arg as it
    is; a plain tensor arg is the same value on every rank.  ``out_maps``
    does the same for the result (a tensor, or a tuple with one map per
    element).  Tensor args are redistributed to these
    layouts, ``fn`` runs on the local tensors (its ops never meet
    DTensor's sharding propagation), and the result is wrapped back; both
    ways are differentiable.  An arg whole on a mesh dim that splits the
    template meets different rows on each rank there, so its local
    gradient is a partial sum over that dim.  Plain tensors run ``fn`` as
    it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(template, DTensor):
        return fn(*args)
    mesh = template.device_mesh

    def layout(dims):
        return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                else Replicate() for p in template.placements]

    def grads(dims):
        return [Partial() if isinstance(p, Shard) and p.dim not in dims
                else q for p, q in zip(template.placements, layout(dims))]

    def whole(a):           # a plain tensor: the same value on every rank
        return a if isinstance(a, DTensor) else DTensor.from_local(
            a, mesh, [Replicate()] * mesh.ndim, run_check=False)

    local = [a if m is None else
             whole(a).redistribute(mesh, layout(m)).to_local(
                 grad_placements=grads(m))
             for a, m in zip(args, maps)]
    out = fn(*local)
    wrap = (lambda t, m: DTensor.from_local(t, mesh, layout(m),
                                            run_check=False))
    if isinstance(out, tuple):
        return tuple(wrap(t, m) for t, m in zip(out, out_maps))
    return wrap(out, out_maps)


# ---------------------------------------------------------------------------
# path-pattern parameter / batch / cache rules
# ---------------------------------------------------------------------------

def path_str(path) -> str:
    """A tree path (``tree.leaves_with_path``'s) as ``'a/b/c'``."""
    return tu.pathstr(path)


# Logical state-axis names -> mesh axes (overridable per call via
# ``rules=``); "dp" is a virtual binding resolved through
# :func:`batch_axes` (``("pod", "data")`` on multi-pod meshes).
DEFAULT_STATE_RULES: Dict[str, AxisBinding] = {
    "fsdp": "data",          # ZeRO-3 dim of every weight / moment
    "tensor": "model",       # TP dim (heads, ffn inner, vocab)
    "expert": "model",       # EP dim of stacked expert weights
    "cache_batch": "dp",     # decode-cache batch/slot dim
    "cache_seq": "model",    # dense KV sequence dim (context parallelism)
    "cache_inner": "model",  # SSM state inner (channels / heads) dim
    "cache_block": None,     # paged pool block dim: replicated — block ids
                             # are global, the host allocator owns them
}


# (path regex, *logical* axis names for the trailing (unstacked) dims)
_RULES = [
    (r"embed/table(_q)?$", ("tensor", "fsdp")),     # vocab x d_model
    (r"lm_head/w(_q)?$", ("fsdp", "tensor")),       # d_model x vocab
    (r"(wq|wk|wv)/w(_q)?$", ("fsdp", "tensor")),    # d_in x (heads*hd)
    (r"wo/w(_q)?$", ("tensor", "fsdp")),            # (heads*hd) x d_model
    (r"(w_in|w_gate)/w(_q)?$", ("fsdp", "tensor")),  # d x d_ff
    (r"w_out/w(_q)?$", ("tensor", "fsdp")),         # d_ff x d
    (r"router/w(_q)?$", ("fsdp", None)),            # d x n_experts
    (r"moe/w_in$", ("expert", "fsdp", "tensor")),   # stacked expert weights
    (r"moe/w_gate$", ("expert", "fsdp", "tensor")),
    (r"moe/w_out$", ("expert", "tensor", "fsdp")),
    (r"in_proj/w(_q)?$", ("fsdp", "tensor")),       # mamba d x inner-ish
    (r"out_proj/w(_q)?$", ("tensor", "fsdp")),
    (r"x_proj/w(_q)?$", ("tensor", None)),          # di x (dt_rank + 2n)
    (r"dt_proj/w(_q)?$", (None, "tensor")),
    (r"conv_w$", (None, "tensor")),            # (K, channels)
    (r"ssm/A_log$", ("tensor", None)),         # mamba1 (di, N); mamba2 (H,)
    (r"ssm/D$", ("tensor",)),                  # mamba1 (di,); mamba2 (H,)
]


def _resolve(name: Optional[str], mesh,
             rules: Dict[str, AxisBinding]) -> Tuple[str, ...]:
    """Logical state-axis name -> tuple of live mesh axes (maybe empty)."""
    if name is None:
        return ()
    binding = rules.get(name)
    if binding == "dp":
        binding = batch_axes(mesh)
    sizes = mesh_axes(mesh)
    return tuple(a for a in _mesh_axes_of(binding) if a in sizes)


def _guarded(dim: int, name: Optional[str], mesh,
             rules: Dict[str, AxisBinding]):
    """Resolve + divisibility guard: the largest suffix of the bound mesh
    axes whose product divides ``dim`` (so smoke shapes replicate instead
    of erroring)."""
    axes = _resolve(name, mesh, rules)
    sizes = mesh_axes(mesh)
    while axes:
        n = 1
        for a in axes:
            n *= sizes[a]
        if dim % n == 0:
            return axes[0] if len(axes) == 1 else axes
        axes = axes[1:]
    return None


def _trailing_spec(path: str, leaf, cfg: ModelConfig, mesh,
                   rules: Optional[Dict[str, AxisBinding]] = None) -> Spec:
    """The spec of one parameter leaf (anything with ``shape`` and
    ``ndim``/``dim()``): the first matching rule's axes on its trailing
    dims, ``None`` on any leading (stacked) dims, then the axis-reuse and
    divisibility guards."""
    rules = DEFAULT_STATE_RULES if rules is None else rules
    shape = tuple(leaf.shape)
    ndim = len(shape)
    tdims = None
    for pat, spec in _RULES:
        if re.search(pat, path):
            tdims = spec
            break
    if tdims is None:
        return (None,) * ndim
    axes = []
    for d in tdims:
        if d == "expert":
            # expert dim: EP when the mesh divides n_experts, else replicate
            # (TP inside experts still applies via the fsdp/tensor dims)
            n_e = cfg.moe.n_experts if cfg.moe else 0
            axes.append(_guarded(n_e, d, mesh, rules) if n_e else None)
        else:
            resolved = _resolve(d, mesh, rules)
            axes.append(resolved[0] if len(resolved) == 1
                        else (resolved or None))
    n_lead = ndim - len(axes)
    if n_lead < 0:
        return (None,) * ndim
    spec = [None] * n_lead + axes
    # EP + TP conflict: a mesh axis may appear at most once per leaf
    used: set = set()
    for i, a in enumerate(spec):
        for ax in _mesh_axes_of(a):
            if ax in used:
                spec[i] = None
                break
        used.update(_mesh_axes_of(spec[i]))
    # divisibility guard: replicate any dim the mesh does not divide
    sizes = mesh_axes(mesh)
    for i, a in enumerate(spec):
        if a is None:
            continue
        n = 1
        for ax in _mesh_axes_of(a):
            n *= sizes[ax]
        if shape[i] % n != 0:
            spec[i] = None
    return tuple(spec)


def param_shardings(params: Any, cfg: ModelConfig, mesh, fsdp: bool = True,
                    rules: Optional[Dict[str, AxisBinding]] = None) -> Any:
    """A tree of specs shaped like ``params`` (tensors, fake or meta
    tensors, or anything with a ``shape``).

    Optimizer moments are params-shaped, so these specs cover them too.
    ``fsdp=False`` (serve-time TP-only mode) drops the fsdp factor of every
    weight spec: weights are resident TP shards and a decode step gathers
    none.
    """
    rules = DEFAULT_STATE_RULES if rules is None else rules
    fsdp_axes = set(_resolve("fsdp", mesh, rules))
    specs = []
    for path, leaf in tu.leaves_with_path(params):
        spec = _trailing_spec(path_str(path), leaf, cfg, mesh, rules)
        if not fsdp:
            spec = tuple(None if a in fsdp_axes else a for a in spec)
        specs.append(spec)
    return tu.unflatten_like(params, specs)


def replicated(mesh) -> Spec:
    """The spec of a replicated 0-d leaf (the optimizer's step)."""
    del mesh
    return ()


def _dp_for(batch_dim: int, mesh):
    """Largest suffix of the DP axes that divides the batch (b=1 ->
    replicate)."""
    return _guarded(batch_dim, "cache_batch", mesh, DEFAULT_STATE_RULES)


def batch_shardings(batch: Any, mesh) -> Any:
    """Data batches: leading dim over the DP axes (guarded, e.g. the
    long_500k cell's global_batch=1 replicates), the rest replicated."""
    return tu.tree_map(
        lambda leaf: (_dp_for(leaf.shape[0], mesh),)
        + (None,) * (len(leaf.shape) - 1), batch)


def cache_shardings(cache: Any, cfg: ModelConfig, mesh,
                    rules: Optional[Dict[str, AxisBinding]] = None) -> Any:
    """Decode caches, bound through the logical state-axis rules.

    Dense int8 KV ``(L, B, Hkv, S, hd)``: batch over ``cache_batch``,
    sequence over ``cache_seq`` (context parallelism — the split softmax is
    associative over keys).  Paged pools ``(L, num_blocks, Hkv, block_k,
    hd)``: block dim over ``cache_block``; block tables batch over
    ``cache_batch``.  SSM states ``(L, B, ...)``: batch over
    ``cache_batch``, the inner (channels / heads) dim over ``cache_inner``.
    Lengths follow the batch; scale tensors replicate.  The branches test
    a leaf's rank, as the reference's do: the port's caches keep the
    reference's stacked ``(L, ...)`` layout.
    """
    rules = DEFAULT_STATE_RULES if rules is None else rules

    def g(dim, name):
        return _guarded(dim, name, mesh, rules)

    def one(key, shape):
        ndim = len(shape)
        if ndim == 5 and ("k_pages" in key or "v_pages" in key):
            return (None, g(shape[1], "cache_block"), None, None, None)
        if ndim == 5 and ("k_q" in key or "v_q" in key
                          or "cross_k" in key or "cross_v" in key):
            return (None, g(shape[1], "cache_batch"), None,
                    g(shape[3], "cache_seq"), None)
        if "block_table" in key:
            return (g(shape[0], "cache_batch"), None)
        if "ssm/conv" in key or ("conv" in key and ndim == 4):
            # (L, B, K-1, C): channels over cache_inner
            return (None, g(shape[1], "cache_batch"), None,
                    g(shape[-1], "cache_inner"))
        if "ssm/h" in key or (key.rsplit("/", 1)[-1] == "h" and ndim >= 4):
            # mamba1 (L,B,di,N) / mamba2 (L,B,H,N,P): inner over cache_inner
            return (None, g(shape[1], "cache_batch"),
                    g(shape[2], "cache_inner")) + (None,) * (ndim - 3)
        if ndim == 1 and "length" in key:
            return (g(shape[0], "cache_batch"),)
        return (None,) * ndim

    specs = [one(path_str(path), tuple(leaf.shape))
             for path, leaf in tu.leaves_with_path(cache)]
    return tu.unflatten_like(cache, specs)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> Tuple:
    """A spec -> one DTensor ``Placement`` per mesh dim of ``mesh`` (a
    ``DeviceMesh`` with ``mesh_dim_names``): ``Shard(d)`` on each mesh axis
    that tensor dim ``d`` names, ``Replicate()`` elsewhere.  A dim sharded
    over several axes is split over them in mesh order (the outer axis
    first), as a ``PartitionSpec`` tuple is."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, a in enumerate(spec)
                    if name in _mesh_axes_of(a)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def place(x: torch.Tensor, mesh, spec: Spec, src: Optional[int] = None):
    """``x`` (the global value, on every rank) as a DTensor laid out by
    ``spec``: each rank keeps its own chunk, nothing is communicated.
    With ``src``, the value is that rank's, scattered (or broadcast) from
    there; the other ranks' ``x`` gives only its shape and dtype."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements(spec, mesh),
                             src_data_rank=src)


def place_tree(tree: Any, specs: Any, mesh, src: Optional[int] = None
               ) -> Any:
    """:func:`place` over a tree and its matching tree of specs."""
    return tu.unflatten_like(tree, [
        place(x, mesh, s, src)
        for x, s in zip(tu.leaves(tree), spec_leaves(specs))])


def spec_leaves(specs: Any):
    """The specs of a spec tree in leaf order (a spec is a tuple, so the
    tree is walked down to tuples of axis names rather than into them)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list) or (isinstance(specs, tuple)
                                   and hasattr(specs, "_fields")):
        return [s for c in specs for s in spec_leaves(c)]
    return [specs]
