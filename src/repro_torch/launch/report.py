"""The roofline table of dry-run reports (port of
``repro/launch/report.py``).

The reference adds an *inner-loop correction* to its terms because XLA's
``cost_analysis`` counts a while-loop body once whatever its trip count,
and its dry-run keeps the k-chunk scan of blocked attention and the chunk
scan of the SSM blocks as loops.  :func:`inner_loop_correction` keeps the
closed forms of those loops' whole cost:

  attention (per attn layer, fakequant/int8 blocked path, block_k=512):
      flops = 4 * B*Hq*S^2*hd * train_mult      (z = QK^T and e.V)
      bytes = 6 * B*Hq*S^2 * 4 * train_mult     (z32/z_q/e/mask/sum f32 chain)
      measured already contains 1/nk of this; correction adds (nk-1)/nk.

  mamba1 (per layer): bytes = 10 * B*S*di*N * 4;  flops = 8 * B*S*di*N
  mamba2/SSD (per layer, chunk c):
      flops = 2*B*S*(c*N + H*c*P + 2*H*N*P);  bytes = 8*B*S*H*c*4
      correction factor (nc-1)/nc with nc = S/c.

The port's dry-run runs every trip of those loops eagerly and counts each
one, so :func:`build_rows` adds no correction: its terms already cover the
loops.

``python -m repro_torch.launch.report reports/dryrun.json`` prints markdown.
"""
from __future__ import annotations

import argparse
import json
from typing import Tuple

from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES
from repro_torch.launch.roofline import PEAK_FLOPS_BF16

BLOCK_K = 512


def inner_loop_correction(arch_name: str, shape_name: str
                          ) -> Tuple[float, float]:
    """(extra_flops, extra_bytes) GLOBAL totals that a count of each loop
    body once misses (the reference's correction, kept for comparison)."""
    arch = get_arch(arch_name)
    cfg = arch.config
    cell = SHAPES[shape_name]
    if cell.kind == "decode":
        return 0.0, 0.0                      # no inner loops at decode
    b, s = cell.global_batch, cell.seq_len
    mult = 3.0 if cell.kind == "train" else 1.0   # fwd + bwd(2x) w/ remat
    extra_fl = extra_by = 0.0

    # ---- attention chunk scan ----------------------------------------------
    n_attn = {"dense": cfg.n_layers,
              "moe": cfg.n_layers,
              "hybrid": cfg.n_layers // cfg.hybrid_attn_every,
              "encdec": (cfg.n_encoder_layers or cfg.n_layers)
              + 2 * cfg.n_layers,
              "ssm": 0}[cfg.family]
    if n_attn:
        s_k = s if cfg.window is None else min(s, cfg.window)
        nk = max(s_k // BLOCK_K, 1)
        fl = 4.0 * b * cfg.n_heads * s * s_k * cfg.hd * mult
        by = 6.0 * b * cfg.n_heads * s * s_k * 4.0 * mult
        extra_fl += n_attn * fl * (nk - 1) / nk
        extra_by += n_attn * by * (nk - 1) / nk

    # ---- ssm chunk scan ------------------------------------------------------
    if cfg.family in ("ssm", "hybrid"):
        sc = cfg.ssm
        c = sc.chunk
        nc = max(s // c, 1)
        if sc.kind == "mamba1":
            di, n = cfg.d_inner, sc.d_state
            fl = 8.0 * b * s * di * n * mult
            by = 10.0 * b * s * di * n * 4.0 * mult
        else:
            di, n, p = cfg.d_inner, sc.d_state, sc.headdim
            h = di // p
            fl = 2.0 * b * s * (c * n + h * c * p + 2 * h * n * p) * mult
            by = 8.0 * b * s * h * c * 4.0 * mult
        extra_fl += cfg.n_layers * fl * (nc - 1) / nc
        extra_by += cfg.n_layers * by * (nc - 1) / nc
    return extra_fl, extra_by


MOVE_HINT = {
    ("memory", "train"): "cut the f32 score-pipeline traffic (bf16 scores, "
                         "triangular causal schedule, a fused training "
                         "attention kernel)",
    ("memory", "prefill"): "the prefill kernel (1) keeps the scores in "
                           "shared memory; the dry-run counts its unfused "
                           "plain version",
    ("memory", "decode"): "decode is param/cache-bound: int8 params + "
                          "batched token parallelism amortize reads",
    ("collective", "train"): "reshard to cut all-gathers: 2D FSDP gather "
                             "overlap, bf16/int8 gradient reduce",
    ("collective", "prefill"): "sequence-shard activations; avoid vocab "
                               "all-gather at the LM head",
    ("collective", "decode"): "KV cache context-parallel partial-softmax "
                              "already minimizes it; shrink logits gather",
    ("compute", "train"): "reduce remat recompute; larger microbatch",
    ("compute", "prefill"): "causal triangular schedule halves score flops",
    ("compute", "decode"): "batch more sequences per step",
}


def _chips(mesh: str) -> int:
    n = 1
    for d in mesh.split("x"):
        n *= int(d)
    return n


def build_rows(reports) -> list:
    """One row per report with a roofline.  The chip count comes from the
    report's mesh.  No inner-loop correction is added: the port's counts
    cover every trip of every loop (see the module docstring)."""
    rows = []
    for r in reports:
        if "roofline" not in r:
            continue
        arch, shape = r["arch"], r["shape"]
        cell = SHAPES[shape]
        s = r["roofline"]
        chips = _chips(r["mesh"])
        terms = {"compute": s["t_compute_s"], "memory": s["t_memory_s"],
                 "collective": s["t_collective_s"]}
        bott = max(terms, key=terms.get)
        step = max(terms.values())
        mfu = s["model_flops"] / (step * chips * PEAK_FLOPS_BF16) if step \
            else 0.0
        total = s["hlo_flops_per_chip"] * chips
        rows.append({
            "arch": arch, "shape": shape, "mesh": r["mesh"],
            "kind": cell.kind,
            "t_compute": terms["compute"], "t_memory": terms["memory"],
            "t_collective": terms["collective"],
            "bottleneck": bott, "mfu": mfu,
            "model_flops": s["model_flops"],
            "useful": s["model_flops"] / total if total else 0.0,
            "hint": MOVE_HINT.get((bott, cell.kind), ""),
            "raw": s,
        })
    return rows


def markdown(rows) -> str:
    out = ["| arch | shape | mesh | compute (ms) | memory (ms) | "
           "collective (ms) | bottleneck | MODEL_FLOPS | useful-flops | "
           "roofline MFU |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['t_compute'] * 1e3:.2f} | {r['t_memory'] * 1e3:.2f} | "
            f"{r['t_collective'] * 1e3:.2f} | **{r['bottleneck']}** | "
            f"{r['model_flops']:.2e} | {r['useful'] * 100:.0f}% | "
            f"{r['mfu'] * 100:.1f}% |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("report", nargs="+")
    ap.add_argument("--hints", action="store_true")
    args = ap.parse_args(argv)
    reports = []
    for p in args.report:
        with open(p) as f:
            reports += json.load(f)
    rows = build_rows(reports)
    print(markdown(rows))
    if args.hints:
        print()
        for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
            print(f"- {r['arch']} x {r['shape']}: {r['bottleneck']}-bound "
                  f"-> {r['hint']}")


if __name__ == "__main__":
    main()
