"""The port's dry-run counts against the JAX reference's, cell by cell.

Each cell runs in both packages on the same config (full width, depth
cut, ``scan_layers=False``) and mesh, each in a child process of its own,
both at once:

* the reference: ``repro.launch.dryrun.dryrun_cell`` over a host-device
  mesh (``XLA_FLAGS=--xla_force_host_platform_device_count``); its matmul
  flops a device are counted from the compiled HLO: 2 x the output's
  elements x the contracted size of every ``dot``, a loop body's times its
  known trip count (XLA's ``cost_analysis`` also counts elementwise work,
  which the port's counter does not);
* the port: ``repro_torch.launch.dryrun.dryrun_cell`` on a ``fake``
  process group, its ``hlo_flops_per_chip`` (matrix products only).

Two terms are one package's by design, and each is counted apart so that
the rest compares like with like: the port's embedding backward, a
one-hot GEMM over the rank's vocab rows (deterministic on the card; the
reference's is a scatter-add, no dot), ``2 x V_rank x T_rank x d``; and
the reference's MoE combine, an einsum against a one-hot ``combine``
tensor, forward and two backward products (the port's combine is a
gather).  Collective bytes a device (result sizes) by kind come from
``launch.roofline`` in each package.

    PYTHONPATH=src python tests/dryrun_parity_torch.py            # (2, 4)
    PYTHONPATH=src python tests/dryrun_parity_torch.py --mesh 16x16 \\
        --out /tmp/parity.json

``tests/test_torch_dryrun_parity.py`` runs it on (2, 4) and bounds the
ratios.  The (16, 16) run needs 256 host devices in the reference's
child; its compile takes minutes a cell.  This script imports neither
package: the children do.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent

# (arch, shape, config overrides): one arch per family at full width,
# depth cut (DeepSeekMoE: its dense layer and one MoE layer; Zamba2: one
# shared-attention call at hybrid_attn_every 6), and one decode cell
CELLS = (
    ("olmo_1b", "train_4k", {"n_layers": 2}),
    ("olmo_1b", "decode_32k", {"n_layers": 2}),
    ("deepseek_moe_16b", "train_4k", {"n_layers": 2}),
    ("falcon_mamba_7b", "train_4k", {"n_layers": 2}),
    ("zamba2_2p7b", "train_4k", {"n_layers": 6}),
    ("seamless_m4t_medium", "train_4k", {"n_layers": 2,
                                         "n_encoder_layers": 2}),
)

_REFERENCE = r'''
import json, re, sys
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_arch
from repro.launch import dryrun
from repro.launch import roofline as rl

shape, names, cells = json.loads(sys.argv[1])
_DEF = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\w+)\[([\d,]*)\]")
_COMP = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+)\s.*\{\s*$")
_CALLS = re.compile(r"(?:calls|to_apply|true_computation|"
                    r"false_computation)=%([\w.\-]+)")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
COMBINE = "bsec,ebcd->bsd"


def dot_flops(hlo):
    """(all dot flops, the MoE combine einsum's) of an optimized HLO module,
    each computation's counted once a call, a while body's trip count
    times."""
    comps, shapes, cur, entry = {}, {}, None, None
    for line in hlo.splitlines():
        m = _COMP.match(line)
        if m and not line.startswith(" "):
            cur = m.group(1)
            comps[cur] = {"dots": [0, 0], "calls": []}
            entry = cur if line.startswith("ENTRY") else entry
            continue
        if cur is None:
            continue
        d = _DEF.match(line)
        if d:
            shapes[d.group(1)] = [int(x) for x in d.group(3).split(",") if x]
        if d and re.search(r"\sdot\(", line):
            lhs = re.findall(r"%([\w.\-]+)",
                             re.search(r"\sdot\(([^)]*)\)", line).group(1))[0]
            dims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
            n = 2
            for x in shapes[d.group(1)]:
                n *= x
            for i in (int(x) for x in dims.group(1).split(",") if x):
                n *= shapes[lhs][i]
            comps[cur]["dots"][0] += n
            if COMBINE in line:
                comps[cur]["dots"][1] += n
        if re.search(r"\swhile\(", line):
            trip = _TRIP.search(line)
            for body in re.findall(r"body=%([\w.\-]+)", line):
                comps[cur]["calls"].append((body, int(trip.group(1))
                                            if trip else 1))
            continue
        comps[cur]["calls"] += [(c, 1) for c in _CALLS.findall(line)]
    memo = {}

    def total(c):
        if c not in memo:
            own = comps[c]["dots"]
            sub = [(k, total(x)) for x, k in comps[c]["calls"]]
            memo[c] = [own[i] + sum(k * t[i] for k, t in sub)
                       for i in (0, 1)]
        return memo[c]
    return total(entry)


seen = {}
analyze = rl.analyze


def capture(compiled, hlo, *a, **k):
    seen["hlo"] = hlo
    return analyze(compiled, hlo, *a, **k)


rl.analyze = capture
n = int(np.prod(shape))
mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))
for arch, cell, over in cells:
    cfg = get_arch(arch).config.replace(scan_layers=False, **over)
    rep = dryrun.dryrun_cell(arch, cell, multi_pod=False, mesh=mesh,
                             config_override=cfg, verbose=False)
    flops, combine = dot_flops(seen.pop("hlo"))
    print(json.dumps({"arch": arch, "shape": cell, "dot_flops": flops,
                      "combine_flops": combine,
                      "coll": rep["roofline"]["coll_breakdown"],
                      "compile_s": rep["compile_s"]}), flush=True)
'''

_PORT = r'''
import json, sys
from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models.layers import pad_vocab

shape, names, cells = json.loads(sys.argv[1])
size = dict(zip(names, shape))
for arch, cell, over in cells:
    cfg = get_arch(arch).config.replace(**over)
    rep = dryrun.dryrun_cell(arch, cell, multi_pod=False,
                             mesh=(shape, names), config_override=cfg,
                             verbose=False)
    sc = SHAPES[cell]
    onehot = 0
    if sc.kind == "train":
        # the embedding's one-hot backward over this rank's vocab rows
        # ("vocab" on "model") and tokens (the batch on "data")
        vp = pad_vocab(cfg.vocab_size, cfg.vocab_pad_multiple)
        tokens = sc.global_batch * sc.seq_len // size.get("data", 1)
        onehot = 2 * vp // size.get("model", 1) * tokens * cfg.d_model
    print(json.dumps({"arch": arch, "shape": cell,
                      "flops": rep["roofline"]["hlo_flops_per_chip"],
                      "onehot_flops": onehot,
                      "coll": rep["roofline"]["coll_breakdown"],
                      "run_s": rep["compile_s"]}), flush=True)
'''


def _child(code: str, arg, env: Dict[str, str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(arg)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _rows(proc: subprocess.Popen, what: str, timeout: float) -> Dict:
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"{what} child failed:\n{err[-3000:]}")
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    return {(r["arch"], r["shape"]): r for r in rows}


def compare(shape=(2, 4), names=("data", "model"), cells=CELLS,
            timeout: float = 3600) -> List[Dict]:
    """Both packages' counts of ``cells`` on the mesh ``shape``, and their
    ratios (port over reference): ``flops_ratio`` with each package's own
    term taken out, ``flops_ratio_raw`` without, ``coll_ratio`` of the
    collective bytes a device."""
    arg = [list(shape), list(names), [list(c) for c in cells]]
    n = 1
    for s in shape:
        n *= s
    src = str(ROOT / "src")
    path = os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")]))
    ref = _child(_REFERENCE, arg, dict(
        os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={n}"))
    port = _child(_PORT, arg, dict(os.environ, PYTHONPATH=path))
    try:
        r_rows, p_rows = (_rows(ref, "reference", timeout),
                          _rows(port, "port", timeout))
    finally:
        for proc in (ref, port):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = []
    for arch, cell, _ in cells:
        r, p = r_rows[(arch, cell)], p_rows[(arch, cell)]
        r_coll, p_coll = sum(r["coll"].values()), sum(p["coll"].values())
        out.append({
            "arch": arch, "shape": cell,
            "mesh": "x".join(str(s) for s in shape),
            "ref_dot_flops": r["dot_flops"],
            "ref_combine_flops": r["combine_flops"],
            "port_flops": p["flops"], "port_onehot_flops": p["onehot_flops"],
            "flops_ratio": (p["flops"] - p["onehot_flops"])
            / (r["dot_flops"] - r["combine_flops"]),
            "flops_ratio_raw": p["flops"] / r["dot_flops"],
            "ref_coll": r["coll"], "port_coll": p["coll"],
            "coll_ratio": p_coll / r_coll if r_coll else None,
        })
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2x4",
                    help="data x model, e.g. 2x4 or 16x16")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split("x"))
    t0 = time.time()
    rows = compare(shape)
    for r in rows:
        print(f"{r['arch']:20s} {r['shape']:11s} {r['mesh']:6s} flops "
              f"{r['flops_ratio']:.4f} (raw {r['flops_ratio_raw']:.4f}) "
              f"collective bytes {r['coll_ratio']:.4f}", flush=True)
    print(f"{len(rows)} cells in {time.time() - t0:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
