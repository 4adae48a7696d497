"""Production meshes and the logical-axis binding the model code reads
(port of ``repro/launch/mesh.py`` onto ``torch.distributed``'s
``DeviceMesh``).

``make_production_mesh`` is a *function*, never a module-level constant, so
importing this module touches no process group: the dry-run sets up its
own (fake) group before it builds a mesh, and the trainer takes its group
from the launcher's environment.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.dist.sharding import batch_axes  # noqa: F401  (re-export)

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def production_shape(*, multi_pod: bool = False):
    """``(shape, axis names)`` of the production mesh: (16, 16) ``("data",
    "model")``, or (2, 16, 16) ``("pod", "data", "model")``."""
    return MULTI_POD if multi_pod else SINGLE_POD


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Sequence[int]] = None,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the default process group, whose
    world size must be the mesh's size.  ``shape`` keeps the production
    axis names at another shape (e.g. ``(1, 1)`` on one card)."""
    from torch.distributed.device_mesh import init_device_mesh
    full, axes = production_shape(multi_pod=multi_pod)
    shape = tuple(shape) if shape is not None else full
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def logical_rules(mesh) -> Dict[str, object]:
    """Logical activation axis -> mesh axis binding (see dist/sharding.py)."""
    return {
        "batch": batch_axes(mesh),
        "heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "embed": None,       # residual stream feature dim replicated
        "seq": "model",      # sequence parallelism (cfg.seq_sharding)
    }
