"""Checkpointing a mesh run above one rank: ``launch.train.main --mesh
single --mesh-shape 1x2`` on two gloo ranks (each a process, the launcher's
environment set by hand), for the smoke TinyLlama and DeepSeekMoE configs;
and the preemption save of a run on one rank, without a mesh.

Every rank gathers each DTensor leaf whole and rank 0 writes the
reference's format; a resume reads it on rank 0 and scatters each leaf by
``param_shardings``.  SIGTERM, which reaches a step at any point of it
(each rank at its own), sets a flag read at the step's end, where the
ranks agree on it and save together.  A test runs 6 steps straight (on
the mesh, their logged losses within 2e-4 of an unbound run's); then a
run that checkpoints at step 3 and is killed (SIGTERM to every rank once
step 3 is logged), and a second run that resumes it and ends at step 6.
Both end on the same checkpoint, bit for bit, and the reference's
``CheckpointManager`` restores it into its own (params, opt_state) tree
with the same leaves.
"""
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw
from repro_torch import tree as tu
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

SRC = Path(__file__).resolve().parent.parent / "src"
ARGS = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
        "--log-every", "1", "--ckpt-every", "3"]
MESH = ["--mesh", "single", "--mesh-shape", "1x2"]
_STEP = re.compile(r"^step\s+(\d+) loss ", re.M)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(arch, steps, ckpt_dir, ranks=2):
    """The ranks of one run, started as ``torchrun`` would start them on
    the (1, 2) mesh, or one process without a mesh; each rank's standard
    error goes to a file beside ``ckpt_dir`` (a pipe nobody reads while
    rank 0's output is followed could fill)."""
    port = str(_free_port())
    procs = []
    for rank in range(ranks):
        err = open(f"{ckpt_dir}.{steps}.rank{rank}.err", "a+")
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
        if ranks > 1:
            env.update(MASTER_ADDR="localhost", MASTER_PORT=port,
                       RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(ranks))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             arch, "--steps", str(steps), "--ckpt-dir", str(ckpt_dir),
             *ARGS, *(MESH if ranks > 1 else [])], env=env,
            stdout=subprocess.PIPE, stderr=err, text=True))
        procs[-1].err = err
    return procs


def _finish(procs, want_rc=0):
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        p.err.seek(0)
        assert p.returncode == want_rc, (p.returncode, p.err.read()[-3000:])
        p.err.close()
        outs.append(out)
    return outs


def _kill_after(procs, step: int):
    """SIGTERM every rank once rank 0 has logged ``step``; returns rank
    0's output up to there."""
    seen = []
    deadline = time.time() + 240
    for line in procs[0].stdout:
        seen.append(line)
        m = _STEP.match(line)
        if m and int(m.group(1)) >= step:
            break
        assert time.time() < deadline, "".join(seen)
    for p in procs:
        p.send_signal(signal.SIGTERM)
    return "".join(seen)


def _straight_and_split(arch, tmp_path, ranks):
    """Rank 0's output of 6 straight steps, and the step the killed run
    stopped at, once its resume has ended at step 6."""
    straight = _finish(_launch(arch, 6, tmp_path / "straight", ranks))[0]
    killed = _launch(arch, 6, tmp_path / "split", ranks)
    head = _kill_after(killed, 3)
    tails = _finish(killed, want_rc=143)
    stopped = CheckpointManager(str(tmp_path / "split")).latest_step()
    assert 3 <= stopped < 6, (stopped, head + tails[0])
    resumed = _finish(_launch(arch, 6, tmp_path / "split", ranks))
    assert all(f"resumed from step {stopped}" in out for out in resumed)
    steps = [int(m.group(1)) for m in _STEP.finditer(resumed[0])]
    assert steps == list(range(stopped + 1, 7))
    return straight, stopped


def _same_checkpoints(arch, tmp_path, stopped):
    """The straight and the split run's step-6 checkpoints, bit for bit;
    the split run's preempted one marked so.  Returns the split run's."""
    cfg = get_arch(arch).smoke.replace(dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    like = train._ckpt_tree(params, adamw.init_state(params), cfg)
    _, a, _ = CheckpointManager(str(tmp_path / "straight")).restore(6, like)
    _, b, extra = CheckpointManager(str(tmp_path / "split")).restore(6, like)
    assert extra == {"final": True}
    assert int(b[1].step) == int(a[1].step) == 6
    for x, y in zip(tu.leaves(a), tu.leaves(b)):
        np.testing.assert_array_equal(x, y)
    preempted = CheckpointManager(str(tmp_path / "split")).restore(
        stopped, like)[2]
    assert preempted == {"preempted": True}
    return b


@pytest.mark.parametrize("arch", ["tinyllama_1p1b", "deepseek_moe_16b"])
def test_mesh_run_checkpoints_and_resumes_bitwise(arch, tmp_path):
    straight, stopped = _straight_and_split(arch, tmp_path, 2)
    # the mesh's losses track an unbound run's (as logged, 4 decimals)
    unbound = train.main(ARGS + ["--arch", arch, "--steps", "6"])
    logged = [float(line.split()[3]) for line in straight.splitlines()
              if _STEP.match(line)]
    np.testing.assert_allclose(logged, unbound["losses"], atol=2e-4)
    b = _same_checkpoints(arch, tmp_path, stopped)

    jcfg = jget_arch(arch).smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(0))
    _, jtree, _ = JCheckpointManager(str(tmp_path / "split")).restore(
        6, (jparams, jadamw.init_state(jparams)))
    jtree = jax.device_get(jtree)
    assert int(jtree[1].step) == 6
    assert jax.tree_util.tree_structure(
        (jtree[0], jtree[1].mu, jtree[1].nu)) == jax.tree_util.tree_structure(
            (b[0], b[1].mu, b[1].nu))
    for x, y in zip(jax.tree.leaves((jtree[0], jtree[1].mu, jtree[1].nu)),
                    jax.tree.leaves((b[0], b[1].mu, b[1].nu))):
        np.testing.assert_array_equal(np.asarray(x), y)


def test_one_rank_saves_on_sigterm_at_a_step_end(tmp_path):
    """One process, no mesh: the signal sets the same flag, read at the
    end of the step it lands in, so the preempted checkpoint holds a whole
    step's parameters and moments (never one caught inside the update);
    the resume ends on the straight run's checkpoint, bit for bit, with
    exit code 143 at the preemption."""
    _, stopped = _straight_and_split("tinyllama_1p1b", tmp_path, 1)
    _same_checkpoints("tinyllama_1p1b", tmp_path, stopped)
