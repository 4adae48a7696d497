"""The training loop and its CLI (port of ``repro/launch/train.py``).

Wires together the config registry, the synthetic data pipeline, the QAT
train step (fakequant attention, AdamW), the checkpoint manager (atomic,
async; a save on SIGTERM at a step's end), the straggler watchdog and,
optionally, the int8 error-feedback gradient compression.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1p1b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

``--smoke`` takes the arch's reduced config in float32.  Run the same
command again after an interruption and it resumes from the latest
checkpoint: the data pipeline is stateless-seeded, so the token stream
continues exactly.  ``--device cpu`` runs on the CPU; the default is the
card.

``--mesh single|multi`` runs the step on the production mesh
(``launch/mesh.py``): parameters and AdamW moments placed as DTensors by
``dist.sharding.param_shardings``, the batch by ``batch_shardings``, the
step under ``axis_rules(mesh, logical_rules(mesh))``.  The process group
comes from the launcher's environment (``torchrun``: NCCL on the card,
gloo on the CPU); ``--mesh-shape`` keeps the production axis names at a
smaller shape, e.g. ``1x1`` on one card:

    torchrun --nproc-per-node 1 -m repro_torch.launch.train \
        --mesh single --mesh-shape 1x1

With ``--ckpt-dir`` on more than one rank, every rank gathers each DTensor
leaf whole and rank 0 writes the reference's format (the ranks meet at a
barrier); a resume reads the checkpoint on rank 0 and scatters each leaf
by its spec.  SIGTERM, which reaches a step at any point of it (each rank
at its own), sets a flag that is read at the step's end, where the ranks
agree on it: the state of that step is saved (together, above one rank)
and the run exits with 143.  Every family trains (an encoder-decoder's
batch carries its frames); ``--layers N`` cuts a config's depth and
keeps its widths.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time
from typing import Dict, List, Optional

import torch

from repro_torch import bridge, resolve_device
from repro_torch import tree as tu
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.dist import compression
from repro_torch.dist import sharding as sh
from repro_torch.dist.straggler import StragglerWatchdog
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import logical_rules, make_production_mesh
from repro_torch.optim import adamw


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1p1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced config in float32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--mesh-shape", default=None,
                    help="the mesh's shape, e.g. 1x1 (default the "
                         "production shape: 16x16, or 2x16x16 for multi)")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient compression "
                         "(repro_torch.dist.compression); the residual is "
                         "not checkpointed — a resume restarts it at zero")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many (decoder) "
                         "layers, its widths kept: a run that one card "
                         "holds (a MoE config keeps its leading dense "
                         "layers)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _ckpt_tree(params, opt_state: adamw.OptState, cfg=None, *,
               layout: bool = True):
    """``(params, opt_state)`` in the reference's stacked layout, as numpy
    copies: what a checkpoint holds (a DTensor gathered whole first; a
    hybrid's layout needs its ``cfg``).  ``layout=False`` only takes part
    in the gathers, for a rank that does not write, and returns None."""
    if not layout:
        for t in tu.leaves((params, opt_state.mu, opt_state.nu)):
            _whole(t)
        return None

    def to_layout(tree):
        return bridge.to_jax_layout(tu.tree_map(_whole, tree), cfg)
    return (to_layout(params),
            adamw.OptState(step=opt_state.step, mu=to_layout(opt_state.mu),
                           nu=to_layout(opt_state.nu)))


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value on every rank (a collective); a plain tensor
    as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _from_rank0(value, multi: bool):
    """``value`` as rank 0 holds it, on every rank (a broadcast above one
    rank)."""
    if not multi:
        return value
    box = [value]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def _any_rank(flag: bool, dev: torch.device, multi: bool) -> bool:
    """Whether ``flag`` is set on any rank (an all-reduce above one
    rank)."""
    if not multi:
        return flag
    t = torch.tensor([int(flag)], device=dev)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t.item())


def _world_size() -> int:
    """The default group's size, or the launcher's ``WORLD_SIZE``."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _setup_mesh(args, dev: torch.device, stack: contextlib.ExitStack):
    """The mesh of ``--mesh`` over the default process group, which is set
    up from the launcher's environment (``env://``) unless the caller
    holds one already; a group set up here is destroyed when ``stack``
    closes."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        stack.callback(dist.destroy_process_group)
    shape = (tuple(int(n) for n in args.mesh_shape.split("x"))
             if args.mesh_shape else None)
    return make_production_mesh(multi_pod=args.mesh == "multi", shape=shape,
                                device_type=dev.type)


def _place_state(params, opt_state: adamw.OptState, cfg, mesh, src=None):
    """Parameters and moments as DTensors laid out by ``param_shardings``
    (the moments are params-shaped, so their specs are the same), from
    every rank's own copy or, with ``src``, from that rank's; the step
    stays a plain host scalar."""
    specs = sh.param_shardings(params, cfg, mesh)
    return (sh.place_tree(params, specs, mesh, src=src),
            adamw.OptState(step=opt_state.step,
                           mu=sh.place_tree(opt_state.mu, specs, mesh,
                                            src=src),
                           nu=sh.place_tree(opt_state.nu, specs, mesh,
                                            src=src)))


def main(argv=None) -> Dict:
    """Run the CLI; returns the run's record: ``losses``, ``ce``,
    ``grad_norms`` and ``lrs`` (floats, one per step run), ``step_s`` (host
    seconds of each step, ending in a host read of its loss),
    ``start_step``, and the final ``params``, ``opt_state`` and ``cfg``
    (with ``--mesh``, DTensors on the mesh, and ``mesh``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.config
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)

    opt_cfg = adamw.OptimizerConfig(peak_lr=args.lr,
                                    warmup_steps=args.warmup,
                                    total_steps=args.steps)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed,
                          frames=cfg.family == "encdec",
                          d_model=cfg.d_model)
    params = st.init_params_fn(cfg)(seed=args.seed, device=dev)
    opt_state = adamw.init_state(params)
    if args.compress_grads:
        train_step = st.make_compressed_train_step(cfg, opt_cfg)
        grad_err = compression.init_error(params)
    else:
        train_step = st.make_train_step(cfg, opt_cfg)
        grad_err = None

    # ---- mesh, checkpoint/resume -------------------------------------------
    rec: Dict[str, List[float]] = {k: [] for k in
                                   ("losses", "ce", "grad_norms", "lrs",
                                    "step_s")}
    start_step = 0
    ckpt: Optional[CheckpointManager] = None
    old_handler = None
    stop = {"signal": False}
    mesh = None
    ctx = contextlib.ExitStack()
    try:
        if args.mesh:
            mesh = _setup_mesh(args, dev, ctx)
        multi = mesh is not None and _world_size() > 1
        rank0 = not multi or torch.distributed.get_rank() == 0
        if args.ckpt_dir:
            ckpt = CheckpointManager(args.ckpt_dir)
            found = _from_rank0(ckpt.latest_step() if rank0 else None, multi)
            if found is not None:
                if rank0:
                    _, (p_np, o_np), _ = ckpt.restore(
                        found, _ckpt_tree(params, opt_state, cfg))
                    params = bridge.from_jax_params(p_np, cfg, device=dev)
                    opt_state = bridge.from_jax_opt_state(o_np, cfg,
                                                          device=dev)
                start_step = found
                opt_state = adamw.OptState(
                    step=torch.tensor(_from_rank0(int(opt_state.step), multi),
                                      dtype=torch.int32),
                    mu=opt_state.mu, nu=opt_state.nu)
                print(f"resumed from step {start_step}", flush=True)
        if mesh is not None:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            # above one rank a restored state is rank 0's alone: placing
            # it scatters each leaf from there
            src = 0 if multi else None
            params, opt_state = _place_state(params, opt_state, cfg, mesh,
                                             src=src)
            if grad_err is not None:
                grad_err = sh.place_tree(
                    grad_err, sh.param_shardings(grad_err, cfg, mesh), mesh)
            ctx.enter_context(sh.axis_rules(mesh, logical_rules(mesh)))
            # the model's host-made tensors (positions, masks) join
            # DTensors as replicated values
            ctx.enter_context(implicit_replication())
        latest = {"step": start_step, "state": (params, opt_state)}

        def save(step: int, extra: Dict, sync: bool = True) -> None:
            """Every rank gathers the state (a collective on a mesh);
            rank 0 writes it; above one rank a synchronous save ends on
            a barrier."""
            tree = _ckpt_tree(*latest["state"], cfg, layout=rank0)
            if rank0:
                if sync:
                    ckpt.wait()
                    ckpt.save(step, tree, extra=extra)
                else:
                    ckpt.save_async(step, tree, extra=extra)
            if multi and sync:
                torch.distributed.barrier()

        if ckpt:
            # the signal only sets a flag: the step it lands in (inside
            # the in-place update, say) runs to its end, where the ranks
            # agree on the flag and that step's state is saved
            old_handler = signal.signal(
                signal.SIGTERM, lambda *_: stop.__setitem__("signal", True))

        watchdog = StragglerWatchdog(
            on_straggler=lambda r: print(
                f"  [straggler] step {r.step}: {r.seconds:.2f}s "
                f"({r.ratio:.1f}x median)", flush=True))

        # ---- loop -----------------------------------------------------------
        t_start = time.time()
        for step in range(start_step, args.steps):
            batch = {k: v.to(dev) for k, v in
                     batch_for_step(data_cfg, step).items()}
            if mesh is not None:
                batch = sh.place_tree(batch, sh.batch_shardings(batch, mesh),
                                      mesh)
            t0 = time.perf_counter()
            if grad_err is not None:
                params, opt_state, grad_err, metrics = train_step(
                    params, opt_state, grad_err, batch)
            else:
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
            loss = float(_whole(metrics["loss"]))  # waits for the step
            rec["step_s"].append(time.perf_counter() - t0)
            watchdog.observe(step, rec["step_s"][-1])
            rec["losses"].append(loss)
            rec["ce"].append(float(_whole(metrics["ce"])))
            rec["grad_norms"].append(float(_whole(metrics["grad_norm"])))
            rec["lrs"].append(float(_whole(metrics["lr"])))
            latest = {"step": step + 1, "state": (params, opt_state)}
            if (step + 1) % args.log_every == 0 or step == start_step:
                print(f"step {step + 1:5d} loss {loss:.4f}"
                      f" ce {rec['ce'][-1]:.4f}"
                      f" lr {rec['lrs'][-1]:.2e}"
                      f" gnorm {rec['grad_norms'][-1]:.2f}", flush=True)
            if ckpt and _any_rank(stop["signal"], dev, multi):
                save(step + 1, {"preempted": True})
                raise SystemExit(143)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                save(step + 1, {"seed": args.seed}, sync=False)
        if ckpt:
            save(args.steps, {"final": True})
    finally:
        ctx.close()
        if ckpt:
            ckpt.wait()
            signal.signal(signal.SIGTERM, old_handler if old_handler
                          is not None else signal.SIG_DFL)
    dt = time.time() - t_start
    n_steps = args.steps - start_step
    print(f"done: {n_steps} steps in {dt:.1f}s "
          f"({dt / max(n_steps, 1):.3f}s/step); "
          f"stragglers flagged: {len(watchdog.reports)}", flush=True)
    return dict(rec, start_step=start_step, params=params,
                opt_state=opt_state, cfg=cfg, mesh=mesh)


if __name__ == "__main__":
    main()
