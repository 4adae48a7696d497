"""Fig.-11-style accuracy study on the PyTorch/CUDA port: float softmax vs
the deployed int8 LUT datapath on a model trained in-framework (offline
stand-in for the paper's TinyLlama + lm-eval-harness evaluation).

The paper evaluates int8 TinyLlama on lm-eval-harness and reports per-task
accuracy deltas within +-0.6 %.  Offline, this reproduces the *transition*
the claim is about — float-softmax model vs the same weights served
through the full int8 LUT datapath — at three levels:

  1. attention-probability error (direct numerics of the approximation),
  2. end-to-end next-token distribution drift (total variation / top-1
     agreement) on a TinyLlama-family model trained in-framework,
  3. a task-accuracy delta on the synthetic HMM next-token task (the
     offline stand-in for the lm-eval tasks).

Run:  PYTHONPATH=src python examples/accuracy_study_torch.py [--steps 300]
(on the card by default, which it needs; ``--device cpu`` for the CPU.
The int8 forward launches the split-softmax prefill kernel on the card.)

The counterpart of ``examples/accuracy_study.py``, which prints
``benchmarks/softmax_accuracy.py``'s ``run``; that file imports JAX, so
this one holds the port's copy of ``prob_error``, ``_train_model``,
``end_to_end`` and ``run``.  The model's initial weights and batches are
the port's own draws unless ``params`` and ``batch_fn`` are given.
"""
from __future__ import annotations

import argparse
from typing import Callable, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tu
from repro_torch.configs import get_arch
from repro_torch.core import split_softmax as ss
from repro_torch.core.lut import LUTConfig
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.launch import steps as st
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

Rows = List[Tuple[str, float, str]]
EVAL_BATCHES = 4


def study_config() -> ModelConfig:
    """TinyLlama's smoke config in f32, the model trained here."""
    return get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")


def prob_error(n: int = 1024, sigma: float = 2.5, seed: int = 0,
               device="cpu") -> Tuple[float, float]:
    """The LUT split softmax's largest and mean absolute error against
    float safe softmax on (64, n) scores of scale ``sigma``."""
    rng = np.random.default_rng(seed)
    z = rng.normal(0, sigma, (64, n)).astype(np.float32)
    cfg = LUTConfig(scale_z=float(np.abs(z).max()) / 127)
    el, rl = ss.make_luts(cfg, device=device)
    zt = torch.from_numpy(z).to(device)
    err = np.abs((ss.safe_softmax(zt)
                  - ss.lut_split_softmax_probs(zt, cfg, el, rl)).cpu().numpy())
    return float(err.max()), float(err.mean())


def _train_model(steps: int = 120, *, params=None, device="cpu",
                 batch_fn: Callable = batch_for_step):
    """``steps`` QAT steps (fakequant attention, AdamW at peak 1.5e-3) of
    the smoke model from ``params`` (default: the port's seed-0 draw on
    the CPU, moved to ``device``):
    (cfg, data config, trained params, last loss)."""
    cfg = study_config()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                    seed=5)
    if params is None:      # drawn on the CPU: one model on either device
        params = tu.tree_map(lambda t: t.to(device),
                             st.init_params_fn(cfg)(seed=0, device="cpu"))
    opt_state = adamw.init_state(params)
    step = st.make_train_step(
        cfg, adamw.OptimizerConfig(peak_lr=1.5e-3, warmup_steps=10,
                                   total_steps=steps))
    for i in range(steps):
        batch = {k: t.to(device) for k, t in batch_fn(dc, i).items()}
        params, opt_state, m = step(params, opt_state, batch)
    return cfg, dc, params, float(m["loss"])


def end_to_end(steps: int = 120, *, params=None, device="cpu",
               batch_fn: Callable = batch_for_step) -> Rows:
    """Train, then run ``EVAL_BATCHES`` held-out batches through the float
    and the int8 forward: band accuracy of each, the total variation and
    the top-1 agreement of their next-token distributions."""
    cfg, dc, params, final_loss = _train_model(
        steps, params=params, device=device, batch_fn=batch_fn)
    eval_batches = [{k: t.to(device) for k, t in
                     batch_fn(dc, 1000 + i).items()}
                    for i in range(EVAL_BATCHES)]

    band = max(cfg.vocab_size // 16, 1)   # HMM latent band (data/pipeline.py)

    def metrics_for(mode):
        mcfg = cfg.replace(attn_mode=mode)
        correct = total = 0
        probs_all = []
        with torch.no_grad():
            for b in eval_batches:
                logits, _ = T.forward(params, b["tokens"], mcfg)
                lg = logits[..., :cfg.vocab_size]
                pred = torch.argmax(lg, -1)
                # band-level accuracy: the learnable structure of the HMM
                # task (exact-token accuracy is ~chance for a smoke model)
                correct += int(torch.sum(pred[:, :-1] // band
                                         == b["labels"][:, :-1] // band))
                total += pred[:, :-1].numel()
                probs_all.append(torch.softmax(lg, -1))
        return correct / total, torch.stack(probs_all)

    # float-softmax baseline vs deployed int8 LUT datapath
    acc_float, p_float = metrics_for("float")
    acc_int8, p_int8 = metrics_for("int8")
    tv = 0.5 * float(torch.mean(torch.sum(torch.abs(p_float - p_int8), -1)))
    top1 = float(torch.mean((torch.argmax(p_float, -1)
                             == torch.argmax(p_int8, -1)).to(torch.float32)))
    return [
        ("accuracy.train_loss", final_loss, f"{steps} steps, smoke model"),
        ("accuracy.task_float", acc_float, "float softmax (baseline)"),
        ("accuracy.task_int8_lut", acc_int8,
         f"delta={100 * (acc_int8 - acc_float):+.3f}% (paper: within "
         f"+-0.6%)"),
        ("accuracy.next_token_tv", tv, "total variation, float vs int8"),
        ("accuracy.top1_agreement", top1, "argmax agreement"),
    ]


def run(steps: int = 120, *, params=None, device="cpu",
        batch_fn: Callable = batch_for_step) -> Rows:
    mx, mean = prob_error(device=device)
    rows = [
        ("accuracy.prob_max_err", mx, "LUT vs float softmax, n=1024"),
        ("accuracy.prob_mean_err", mean, "LUT vs float softmax, n=1024"),
    ]
    rows += end_to_end(steps, params=params, device=device, batch_fn=batch_fn)
    return rows


def main(argv=None) -> Rows:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    rows = run(steps=args.steps, device=resolve_device(args.device))
    for name, val, derived in rows:
        print(f"{name:28s} {val:10.5f}   {derived}")
    return rows


if __name__ == "__main__":
    main()
