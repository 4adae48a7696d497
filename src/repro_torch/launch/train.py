"""The training loop and its CLI (port of ``repro/launch/train.py``).

Wires together the config registry, the synthetic data pipeline, the QAT
train step (fakequant attention, AdamW), the checkpoint manager (atomic,
async, a save on SIGTERM), the straggler watchdog and, optionally, the int8
error-feedback gradient compression.

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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _ckpt_tree(params, opt_state: adamw.OptState):
    """``(params, opt_state)`` in the reference's stacked layout, as numpy
    copies: what a checkpoint holds (a DTensor gathered whole first)."""
    def layout(tree):
        return bridge.to_jax_layout(tu.tree_map(_whole, tree))
    return (layout(params),
            adamw.OptState(step=opt_state.step, mu=layout(opt_state.mu),
                           nu=layout(opt_state.nu)))


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value on every rank (a collective); a plain tensor
    as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


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


def _place_state(params, opt_state: adamw.OptState, cfg, mesh):
    """Parameters and moments as DTensors laid out by ``param_shardings``
    (the moments are params-shaped, so their specs are the same); the
    step stays a plain host scalar."""
    specs = sh.param_shardings(params, cfg, mesh)
    return (sh.place_tree(params, specs, mesh),
            adamw.OptState(step=opt_state.step,
                           mu=sh.place_tree(opt_state.mu, specs, mesh),
                           nu=sh.place_tree(opt_state.nu, specs, mesh)))


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
    if cfg.family != "dense":
        item = {"moe": "5, the open half of the MoE family"}.get(
            cfg.family, "4")
        raise NotImplementedError(
            f"{cfg.name}: the port trains the dense family only; training "
            f"the {cfg.family} family is ROADMAP queue 1 item {item}")

    opt_cfg = adamw.OptimizerConfig(peak_lr=args.lr,
                                    warmup_steps=args.warmup,
                                    total_steps=args.steps)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    params = st.init_params_fn(cfg)(seed=args.seed, device=dev)
    opt_state = adamw.init_state(params)
    if args.compress_grads:
        train_step = st.make_compressed_train_step(cfg, opt_cfg)
        grad_err = compression.init_error(params)
    else:
        train_step = st.make_train_step(cfg, opt_cfg)
        grad_err = None

    if args.mesh and args.ckpt_dir and _world_size() > 1:
        raise NotImplementedError(
            "--ckpt-dir with --mesh on more than one rank: a checkpoint is "
            "written by one process; run the mesh at 1 rank, or without a "
            "checkpoint directory")

    # ---- checkpoint/resume -------------------------------------------------
    start_step = 0
    ckpt: Optional[CheckpointManager] = None
    old_handler = None
    latest = {"step": 0, "state": (params, opt_state)}
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        if ckpt.latest_step() is not None:
            start_step, (p_np, o_np), _ = ckpt.restore(
                None, _ckpt_tree(params, opt_state))
            params = bridge.from_jax_params(p_np, cfg, device=dev)
            opt_state = bridge.from_jax_opt_state(o_np, cfg, device=dev)
            print(f"resumed from step {start_step}", flush=True)
        latest = {"step": start_step, "state": (params, opt_state)}
        old_handler = ckpt.install_sigterm_handler(
            lambda: (latest["step"], _ckpt_tree(*latest["state"])))

    watchdog = StragglerWatchdog(
        on_straggler=lambda r: print(
            f"  [straggler] step {r.step}: {r.seconds:.2f}s "
            f"({r.ratio:.1f}x median)", flush=True))

    # ---- loop ---------------------------------------------------------------
    rec: Dict[str, List[float]] = {k: [] for k in
                                   ("losses", "ce", "grad_norms", "lrs",
                                    "step_s")}
    mesh = None
    ctx = contextlib.ExitStack()
    try:
        if args.mesh:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            mesh = _setup_mesh(args, dev, ctx)
            params, opt_state = _place_state(params, opt_state, cfg, mesh)
            if grad_err is not None:
                grad_err = sh.place_tree(
                    grad_err, sh.param_shardings(grad_err, cfg, mesh), mesh)
            latest = {"step": start_step, "state": (params, opt_state)}
            ctx.enter_context(sh.axis_rules(mesh, logical_rules(mesh)))
            # the model's host-made tensors (positions, masks) join
            # DTensors as replicated values
            ctx.enter_context(implicit_replication())
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
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save_async(step + 1, _ckpt_tree(params, opt_state),
                                extra={"seed": args.seed})
        if ckpt:
            ckpt.wait()
            ckpt.save(args.steps, _ckpt_tree(params, opt_state),
                      extra={"final": True})
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
