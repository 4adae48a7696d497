"""Dry-run: run every (architecture x shape x mesh) step on a fake mesh and
count its per-device cost (port of ``repro/launch/dryrun.py``).

This is the proof that the distribution config is coherent without the
hardware.  A process group over ``torch.distributed``'s ``fake`` backend
stands in for the mesh's GPUs (rank 0 of 256 or 512); parameters,
optimizer moments, the batch and the decode cache are ``meta`` tensors (no
storage) placed as DTensors by ``param_shardings`` / ``batch_shardings`` /
``cache_shardings``; the train, prefill or decode step runs eagerly under
the production ``axis_rules`` binding, and a dispatch mode below DTensor
counts rank 0's local aten ops.  The kernel wrappers see CPU-side
(``meta``) tensors and take their plain versions, as the reference's
dry-run takes its XLA twins off a TPU.

What it reports, per cell, with the reference's keys:

* ``memory.argument_size_in_bytes`` — the per-device bytes of the placed
  inputs, exact; ``output_size_in_bytes`` and ``alias_size_in_bytes`` —
  the outputs' local bytes and the part of them that updates an input in
  place.  Temporaries are not counted: eager execution has no compiled
  buffer assignment to read them from.
* ``roofline`` — :class:`launch.roofline.RooflineTerms` of the counts:
  the flops of ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention; no elementwise flops, which XLA's
  ``cost_analysis`` counts), each op's input plus output bytes (an unfused
  count, where XLA counts per fusion), and the result sizes of the c10d
  functional collectives by kind.  A loop runs every trip eagerly, so
  every trip is counted (XLA counts a loop body once).
* ``lower_s`` — seconds to build and place the inputs; ``compile_s`` —
  seconds to run the step under the counters.

The mesh is built on the ``cpu`` device type (the fake backend has no
card behind it), so DTensor's redistributions are the ones it picks for a
CPU group: an all-to-all becomes an all-gather and a chunk.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun               # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
        --shape train_4k --mesh single                              # one
    ... --out reports/dryrun.json --jobs 8
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import tree as tu
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import (SHAPES, ShapeCell, cache_len_for,
                                      cache_specs_for, input_specs_for)
from repro_torch.core import attention as core_attn
from repro_torch.dist import sharding as sh
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import logical_rules, production_shape
from repro_torch.optim import adamw

_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts the local (per-device) ops that run on ``meta`` tensors:
    flops by ``torch.utils.flop_counter``'s formulas, input plus output
    bytes of every op that is not a view, and each functional collective's
    result bytes by kind.  An op on DTensors is deferred to DTensor, whose
    local ops then come back through this mode."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flops = flop_registry
        self.flops = 0
        self.hbm_bytes = 0
        self.coll = {k: 0 for k in rl.COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not any(t.device.type == "meta" for t in outs):
            return out           # DTensor's own host-side bookkeeping
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns == "_c10d_functional":
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                self.coll[kind] += sum(_nbytes(t) for t in outs)
            return out
        if func.is_view or name.startswith("empty"):
            return out
        fn = self._flops.get(func.overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group over the ``fake`` backend (rank 0 of
    ``world_size``), destroyed on exit; refuses to replace a live group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already set up; the dry-run "
                           "runs in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta(tree):
    return tu.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                             device="meta"), tree)


def _meta_params(cfg, serve_cell: bool):
    """The parameters' shapes and dtypes on ``meta``: the f32 training
    init, cast to bf16 for a bf16 serve cell or quantized to int8 for an
    int8 one (as the reference's dry-run does)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = st.init_params_fn(cfg)(seed=0, device="cpu")
    params = _meta(params)
    if serve_cell and cfg.serve_param_dtype == "bfloat16":
        params = tu.tree_map(
            lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32
            else t, params)
    elif serve_cell and cfg.serve_param_dtype == "int8":
        from repro_torch.core.quantization import (
            quantize_weights_for_serving)
        params = quantize_weights_for_serving(params)
    return params


def _local_bytes(tree) -> int:
    total = 0
    for t in tu.leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += _nbytes(t)
    return total


def dryrun_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
                verbose: bool = True,
                mesh: Optional[Tuple[Sequence[int], Sequence[str]]] = None,
                config_override=None, cell: Optional[ShapeCell] = None
                ) -> Dict:
    """Run one (arch, shape, mesh) cell on a fake mesh; return the report.

    ``mesh`` is ``(shape, axis names)``, default the production mesh
    (``multi_pod`` picks which).  ``config_override`` runs another config
    (inputs and caches are made for it); ``cell`` a shape outside the grid
    (``shape_name`` then only labels it).  The process group is set up and
    torn down here, so the caller must not hold one.
    """
    cfg = config_override or get_arch(arch_name).config
    cell = cell or SHAPES[shape_name]
    shape, names = mesh or production_shape(multi_pod=multi_pod)
    chips = 1
    for n in shape:
        chips *= n
    report = {"arch": arch_name, "shape": shape_name,
              "mesh": "x".join(str(s) for s in shape), "kind": cell.kind}
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    with fake_world(chips):
        dmesh = init_device_mesh("cpu", tuple(shape),
                                 mesh_dim_names=tuple(names))
        t0 = time.time()
        serve_cell = cell.kind != "train"
        params = _meta_params(cfg, serve_cell)
        p_specs = sh.param_shardings(
            params, cfg, dmesh,
            fsdp=not (serve_cell and cfg.serve_param_sharding == "tp"))
        params = sh.place_tree(params, p_specs, dmesh)
        batch = input_specs_for(cfg, cell)
        batch = sh.place_tree(batch, sh.batch_shardings(batch, dmesh), dmesh)
        args: Tuple = ()
        counter = StepCounter()
        # each cell counts its LUT pair's upload, whatever cell ran before
        # it in this process (``luts_for`` keeps the tables it made)
        core_attn.luts_for.cache_clear()
        with sh.axis_rules(dmesh, logical_rules(dmesh)), \
                implicit_replication():
            if cell.kind == "train":
                opt = adamw.init_state(params)     # moments placed as params
                step_fn = st.make_train_step(
                    cfg, adamw.OptimizerConfig(total_steps=1000))
                args = (params, opt, batch)
            elif cell.kind == "prefill":
                step_fn = st.make_prefill_step(
                    cfg, cache_len_for(cfg, cell),
                    place=lambda c: sh.place_tree(
                        c, sh.cache_shardings(c, cfg, dmesh), dmesh))
                args = (params, batch)
            else:
                cache = cache_specs_for(cfg, cell, cache_len_for(cfg, cell))
                cache = sh.place_tree(
                    cache, sh.cache_shardings(cache, cfg, dmesh), dmesh)
                step_fn = st.make_decode_step(cfg)
                args = (params, batch["token"], cache)
            arg_bytes = _local_bytes(args)
            report["lower_s"] = round(time.time() - t0, 1)
            t1 = time.time()
            with counter:
                out = step_fn(*args)
            report["compile_s"] = round(time.time() - t1, 1)
        in_ids = {id(t) for t in tu.leaves(args)}
        out_leaves = [t for t in tu.leaves(out) if isinstance(t, torch.Tensor)]
        report["memory"] = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": _local_bytes(out_leaves),
            "alias_size_in_bytes": _local_bytes(
                [t for t in out_leaves if id(t) in in_ids]),
        }
    terms = rl.RooflineTerms(
        flops=float(counter.flops), hbm_bytes=float(counter.hbm_bytes),
        coll_bytes=float(sum(counter.coll.values())),
        coll_breakdown=dict(counter.coll),
        model_flops=rl.model_flops_for(cfg, cell.kind, cell.seq_len,
                                       cell.global_batch),
        chips=chips)
    report["roofline"] = terms.summary()
    if verbose:
        arg = report["memory"]["argument_size_in_bytes"] / 2**30
        s = terms.summary()
        print(f"  [OK] place {report['lower_s']}s run {report['compile_s']}s"
              f" | args {arg:.2f}GiB | compute {s['t_compute_s']*1e3:.2f}ms"
              f" memory {s['t_memory_s']*1e3:.2f}ms collective "
              f"{s['t_collective_s']*1e3:.2f}ms -> {s['bottleneck']} "
              f"| MFU@roofline {s['roofline_mfu']*100:.1f}% "
              f"useful-flops {s['useful_flops_ratio']*100:.1f}%",
              flush=True)
    return report


def _cell_in_subprocess(arch_name: str, shape_name: str, mesh_flag: str
                        ) -> Dict:
    """One cell in a child process of its own (a process group each)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cell.json")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch_name, "--shape", shape_name, "--mesh", mesh_flag,
             "--out", out], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if os.path.exists(out):
            with open(out) as f:
                rows = json.load(f)
            if rows:
                return rows[0]
        mesh_name = "x".join(str(s) for s in production_shape(
            multi_pod=mesh_flag == "multi")[0])
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                "error": (proc.stderr or "no report")[-500:]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="reports/dryrun.json")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a child process")
    args = ap.parse_args(argv)

    arch_ids = [args.arch] if args.arch else [
        a for a in ARCH_IDS if a != "tinyllama_1p1b"]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    existing = {}
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for r in json.load(f):
                existing[(r["arch"], r["shape"], r.get("mesh"))] = r

    results = list(existing.values())
    todo = []
    for arch_name in arch_ids:
        arch = get_arch(arch_name)
        shapes = [args.shape] if args.shape else list(arch.shapes())
        for shape_name in shapes:
            if shape_name in arch.skip_shapes:
                print(f"{arch_name} x {shape_name}: SKIP "
                      f"({arch.skip_shapes[shape_name]})", flush=True)
                results.append({"arch": arch_name, "shape": shape_name,
                                "skipped": arch.skip_shapes[shape_name]})
                continue
            for mp in meshes:
                mesh_name = "x".join(
                    str(s) for s in production_shape(multi_pod=mp)[0])
                if (arch_name, shape_name, mesh_name) not in existing:
                    todo.append((arch_name, shape_name, mp, mesh_name))

    def run(item):
        arch_name, shape_name, mp, mesh_name = item
        if args.jobs > 1:
            return _cell_in_subprocess(arch_name, shape_name,
                                       "multi" if mp else "single")
        print(f"{arch_name} x {shape_name} x {mesh_name}:", flush=True)
        try:
            return dryrun_cell(arch_name, shape_name, multi_pod=mp)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            return {"arch": arch_name, "shape": shape_name,
                    "mesh": mesh_name, "error": str(e)[:500]}

    t0 = time.time()
    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        done = list(pool.map(run, todo))
    results += done
    failures = [r for r in done if "error" in r]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1, default=float)
    print(f"\nwrote {args.out}; {len(done)} cells in "
          f"{time.time() - t0:.1f} s, {len(failures)} failures")
    for r in failures:
        print("  FAIL:", (r["arch"], r["shape"], r["mesh"]))
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
