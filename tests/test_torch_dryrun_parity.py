"""The port's dry-run counts held against the reference's
(``tests/dryrun_parity_torch.py``, both packages in child processes,
about a minute): one arch per family at full width with the depth cut
(OLMo-1B, DeepSeekMoE-16B with its dense layer and one MoE layer,
Falcon-Mamba-7B at 2 layers, Zamba2-2.7B at 6 with one shared-attention
call, SeamlessM4T-medium at 2 + 2), ``train_4k``, and OLMo-1B x
``decode_32k``, on a (2, 4) ("data", "model") mesh: the reference over 8
host devices, the port over a ``fake`` process group.

Bounds, port over reference, per device:

* matmul flops within 10% in every cell, each package's own term taken
  out: the port's embedding backward is a one-hot GEMM over the rank's
  vocab rows (deterministic on the card; ``2 x V/4 x T x d``), the
  reference's a scatter-add; the reference's MoE combine is an einsum
  against a one-hot tensor (forward and two backward products), the
  port's a gather.  Measured 0.9515 (OLMo train), 1.0000 (decode),
  0.9707, 1.0001, 0.9885, 0.9800.
* collective bytes (result sizes, all kinds) within 5% of the ratio
  measured after the last fix, so that neither side's count moves
  unseen; a fix updates its bound.  Each gradient is laid out as its
  parameter once, after the backward (``steps.value_and_grad``), where
  the optimizer reduced a partial gradient at each of its three uses and
  kept ``wo``'s whole on every "model" rank.  1.0805 (OLMo), 0.7954 (the
  decode's embedding reduces its few rows where the reference gathers
  the table over "data"), 1.3241 (DeepSeekMoE: the combine reduces each
  rank's partial sums over its own experts, (B, S, d), in the model
  dtype as the reference's einsum, and its checkpointed recompute reuses
  that result, ``sharding.kept_for_backward``; what remains above the
  reference is mostly the attention's and the MLPs' reduces, issued
  again in the recompute, where XLA's are fewer), 0.2231 (Falcon-Mamba:
  the reference's 85.9 GB of collective-permute, which moves the halves
  of Mamba-1's ``in_proj`` output, split at a boundary that is not the
  shards'; the port splits the weight instead,
  ``layers.split_linear_apply``), 0.2573 (Zamba2: the shared block's
  output takes the residual stream's placement, so neither the Mamba-2
  block's input nor the shared MLP's cotangent is a partial sum; the
  reference's 168.2 GB of collective-permute has no counterpart),
  1.1942.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

FLOPS_TOL = 0.10
COLL_TOL = 0.05
COLL_RATIO = {
    ("olmo_1b", "train_4k"): 1.0805,
    ("olmo_1b", "decode_32k"): 0.7954,
    ("deepseek_moe_16b", "train_4k"): 1.3241,
    ("falcon_mamba_7b", "train_4k"): 0.2231,
    ("zamba2_2p7b", "train_4k"): 0.2573,
    ("seamless_m4t_medium", "train_4k"): 1.1942,
}


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("parity") / "rows.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "dryrun_parity_torch.py"),
         "--mesh", "2x4", "--out", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return {(r["arch"], r["shape"]): r for r in json.loads(out.read_text())}


@pytest.mark.parametrize("cell", sorted(COLL_RATIO))
def test_matmul_flops_within_ten_percent(rows, cell):
    r = rows[cell]
    assert r["port_flops"] > 0 and r["ref_dot_flops"] > 0
    assert abs(r["flops_ratio"] - 1) <= FLOPS_TOL, r
    if cell[1] == "train_4k":
        assert r["port_onehot_flops"] > 0
    assert (r["ref_combine_flops"] > 0) == (cell[0] == "deepseek_moe_16b")


@pytest.mark.parametrize("cell", sorted(COLL_RATIO))
def test_collective_bytes_within_their_bound(rows, cell):
    r = rows[cell]
    want = COLL_RATIO[cell]
    assert abs(r["coll_ratio"] / want - 1) <= COLL_TOL, (r["coll_ratio"], r)
    # the fake CPU group has no all-to-all (DTensor gathers and chunks)
    # and DTensor issues no collective-permute
    assert r["port_coll"]["all-to-all"] == r["port_coll"][
        "collective-permute"] == 0
