"""``examples/{train_lm, serve_batched, multi_pod_lower}_torch.py`` on
the CPU.

* train_lm: the smoke default cut to ``--steps 6 --ckpt-every 3`` (and
  ``--log-every 1``) against the reference's ``launch.train.main`` with
  the JAX example's argument list and the same cut.  The port's run
  starts from the reference's ``PRNGKey(0)`` parameters, bridged, and
  reads the reference's batches (its own ``init_params_fn`` and
  ``batch_for_step`` replaced for the run): each step's loss within 3e-4
  of the reference's, which prints 4 decimals (measured under 1.5e-4).  The
  same command again resumes from the step-6 checkpoint.  An interrupted
  run's resume is held by
  ``test_torch_mesh_checkpoint.py::test_one_rank_saves_on_sigterm_at_a_step_end``.
* serve_batched: ``--device cpu`` serves all 8 requests, 16 tokens each,
  and leaks no block (token parity with the reference on this path:
  ``test_torch_serve.py``).
* multi_pod_lower: the report equals ``dryrun_cell``'s for the same cell
  but for its two host-time fields.  The JAX example is not imported: it
  sets ``XLA_FLAGS`` at import time.
"""
import contextlib
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import dryrun
from repro_torch.launch import steps as st
from repro_torch.launch import train
from test_torch_examples_quickstart import bridged_params, jax_batches, load

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
CUT = ["--steps", "6", "--ckpt-every", "3", "--log-every", "1"]
_STEP = re.compile(r"^step +(\d+) loss (\d+\.\d+)")

torch.set_num_threads(1)


def _load(name: str):
    return load(EXAMPLES / f"{name}.py", name)


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args)
    return ret, out.getvalue()


def _jax_example_argv(ckpt_dir) -> list:
    """The JAX example's smoke argument list, as its ``__main__`` builds
    it, with the cut appended."""
    return ["--arch", "tinyllama_1p1b", "--smoke", "--steps", "60",
            "--batch", "8", "--seq", "128", "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", "20"] + CUT


def test_jax_example_argument_list_is_the_one_copied():
    src = (EXAMPLES / "train_lm.py").read_text()
    for flag in ('"--smoke", "--steps", "60"', '"--batch", "8", "--seq", '
                 '"128"', '"--ckpt-every", "20"'):
        assert flag in src


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_lm")
    _, jout = _stdout(jtrain.main, _jax_example_argv(tmp / "jax"))
    ex = _load("train_lm_torch")
    argv = CUT + ["--device", "cpu", "--ckpt-dir", str(tmp / "port")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(st, "init_params_fn",
                   lambda cfg: lambda seed, device: bridged_params(cfg))
        mp.setattr(train, "batch_for_step", jax_batches)
        rec, out = _stdout(ex.main, argv)
        again, out2 = _stdout(ex.main, argv)
    return jout, rec, out, again, out2


def test_train_lm_losses_track_the_reference(train_runs):
    jout, rec, out, _, _ = train_runs
    want = [float(m.group(2)) for m in map(_STEP.match, jout.splitlines())
            if m]
    logged = [float(m.group(2)) for m in map(_STEP.match, out.splitlines())
              if m]
    assert len(want) == len(rec["losses"]) == 6
    np.testing.assert_allclose(rec["losses"], want, atol=3e-4)
    np.testing.assert_allclose(logged, want, atol=3e-4)


def test_train_lm_second_run_resumes(train_runs):
    _, rec, _, again, out2 = train_runs
    assert "resumed from step 6" in out2
    assert again["start_step"] == 6 and again["losses"] == []
    assert rec["start_step"] == 0


def test_train_lm_default_ckpt_dir_is_its_own():
    ex = _load("train_lm_torch")
    assert ex.CKPT_DIR != "/tmp/cimple_train_ckpt"
    assert '"/tmp/cimple_train_ckpt"' in (EXAMPLES / "train_lm.py").read_text()


def test_serve_batched_serves_every_request_without_a_leak():
    stats, out = _stdout(_load("serve_batched_torch").main, ["--device", "cpu"])
    assert stats["served"] == 8 and stats["leaked_blocks"] == 0
    assert sorted(stats["finished"]) == list(range(8))
    assert all(len(t) == 16 for t in stats["finished"].values())
    assert "served 8 requests" in out and "0 leaked blocks" in out


HOST_TIMES = ("lower_s", "compile_s")


def test_multi_pod_lower_report_equals_dryrun_cell():
    report, out = _stdout(_load("multi_pod_lower_torch").main,
                          ["--arch", "olmo_1b", "--shape", "decode_32k"])
    printed = json.loads(out[out.index("{"):])
    assert printed == json.loads(json.dumps(report, default=float))
    direct = dryrun.dryrun_cell("olmo_1b", "decode_32k", multi_pod=True,
                                verbose=False)
    for rep in (report, direct):
        for key in HOST_TIMES:
            rep.pop(key)
    assert report == direct
    assert report["mesh"] == "2x16x16"
    roof = report["roofline"]
    assert roof["hlo_flops_per_chip"] > 0 and roof["hbm_bytes_per_chip"] > 0
    assert roof["coll_bytes_per_chip"] > 0
