"""Perf hillclimb driver: run one dry-run cell under a named change-set and
report its roofline terms (port of ``repro/launch/perf.py``; hypothesis ->
change -> before -> after).

    PYTHONPATH=src python -m repro_torch.launch.perf --arch olmo_1b \\
        --shape train_4k --variant bf16_scores,triangular

Variants (cumulative when comma-joined):
  bf16_scores  — attention score chain in bf16 (memory lever)
  triangular   — causal q-chunked schedule, live-k scans only (flops+bytes)
  bf16_logits  — LM head emits bf16 (logits traffic + vocab collectives)
  seq_shard    — residual stream seq-sharded over "model" between blocks
  tp_serve     — serve-time params TP-only sharded (kills the per-step FSDP
                 all-gather; requires bf16 params to fit HBM)
  int8_serve   — TP-only + int8 resident weights with dequant-on-use (the
                 paper's own serving precision; halves param reads again)
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import dryrun_cell


def apply_variant(cfg, names):
    for name in names:
        if not name:
            continue
        if name == "bf16_scores":
            cfg = cfg.replace(attn_score_dtype="bfloat16")
        elif name == "triangular":
            cfg = cfg.replace(attn_triangular=True)
        elif name == "bf16_logits":
            cfg = cfg.replace(logits_dtype="bfloat16")
        elif name == "seq_shard":
            cfg = cfg.replace(seq_sharding=True)
        elif name == "tp_serve":
            cfg = cfg.replace(serve_param_sharding="tp",
                              serve_param_dtype="bfloat16")
        elif name == "int8_serve":
            cfg = cfg.replace(serve_param_sharding="tp",
                              serve_param_dtype="int8")
        else:
            raise ValueError(name)
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="", help="comma list")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    names = args.variant.split(",") if args.variant else []
    cfg = apply_variant(arch.config, names)
    report = dryrun_cell(args.arch, args.shape, multi_pod=False,
                         config_override=cfg)
    report["variant"] = args.variant or "baseline"
    if args.out:
        rows = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                rows = json.load(f)
        rows.append(report)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=float)
    print(json.dumps(report["roofline"], indent=2, default=float))


if __name__ == "__main__":
    main()
