"""repro_torch.dist — the distributed-execution substrate (port of
``repro/dist`` onto ``torch.distributed``'s ``DeviceMesh`` and DTensor).

Design note
===========

Logical-axis scheme (``dist.sharding``)
---------------------------------------
Model code never names mesh axes.  It annotates activations with *logical*
axes drawn from a closed vocabulary::

    batch   global batch            -> all data-parallel mesh axes
    heads   attention heads         -> "model" (tensor parallelism)
    mlp     FFN / SSM inner dim     -> "model"
    vocab   (padded) vocabulary     -> "model"
    expert  routed-expert dim       -> "model" (expert parallelism)
    seq     sequence                -> "model" (context parallelism, opt-in)
    embed   residual-stream feature -> replicated

``shard(x, *logical_axes)`` resolves those names through the binding that
``axis_rules(mesh, rules)`` installs (``launch/mesh.py: logical_rules`` is
the production binding) and redistributes a DTensor to the result, its
gradient too.  With no binding active, ``shard`` is the identity — one
model source serves single-device runs, the 256-GPU mesh and the 512-GPU
two-pod mesh.  Resolution is guarded: a mesh axis is used at most once per
array and any dim the bound axes do not divide replicates, so annotations
are always legal, never load-bearing for correctness — only for placement.

Parameter/optimizer/cache placement is *path-pattern* based
(``param_shardings`` / ``batch_shardings`` / ``cache_shardings``): FSDP over
"data", TP/EP over "model", pure DP over "pod".  Each returns a spec per
leaf (a tuple of mesh-axis names, the counterpart of a ``PartitionSpec``);
``placements`` / ``place_tree`` turn specs into DTensors.  Patterns match
trailing dims, so the reference's stacked layer segments and the port's
per-layer lists get the same per-layer specs.

DTensor picks a strategy op by op, by the bytes it would move; where an
op has none (a ``scatter_``, an in-place write into a sharded cache), the
region runs on each rank's local blocks (``per_rank``, the cache writer in
``models/attention.py``) with the placements the annotations give.

Error-feedback invariant (``dist.compression``)
-----------------------------------------------
The inter-pod gradient all-reduce ships int8, not f32.  Correctness rests on
one algebraic invariant, enforced by test::

    g + e == dequant(quant(g + e)) + e'

The residual ``e'`` (what int8 could not represent this step) is carried
into the next step's quantization, so compression *defers* information, it
never drops it.  ``compressed_psum(grads, err, axis_name)`` is the one entry
point: ``axis_name=None`` gives the identity reduce with identical
quantization numerics, a process group (or a bound mesh dim's name)
all-gathers the int8 payload (the wire format) and means locally.

Straggler detection (``dist.straggler``)
----------------------------------------
Synchronous data parallelism runs at the pace of the slowest host.
``StragglerWatchdog`` flags steps slower than ``threshold`` x the windowed
*median* duration and emits structured :class:`StragglerReport`\\ s —
advisory, never fatal; the trainer logs them.
"""
from repro_torch.dist import compression, sharding, straggler  # noqa: F401
from repro_torch.dist.sharding import axis_rules, shard  # noqa: F401
from repro_torch.dist.straggler import (StragglerReport,  # noqa: F401
                                        StragglerWatchdog)
