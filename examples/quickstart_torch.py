"""Quickstart on the PyTorch/CUDA port: the CIMple datapath in five minutes.

1. Build the exp/reciprocal LUT pair and compare LUT split softmax against
   float safe softmax.
2. Run the same attention through all three modes (float / fakequant /
   int8); the int8 mode launches the split-softmax prefill kernel on the
   card.
3. Train a tiny llama-family model for a few steps and greedy-decode from it
   through the int8 KV cache (the prefill kernel once a layer, the fused
   dense decode kernel once a layer a token).

Run on the card (the default; it fails without one) or on the CPU, where
every kernel wrapper takes its plain PyTorch version:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The counterpart of ``examples/quickstart.py``: the same inputs from
``np.random.default_rng(0)`` and the same printed lines.  The model's
initial weights and the training batches are the port's own draws
(``torch.Generator`` on the CPU, and numpy), not ``jax.random``'s.
"""
import argparse
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tu
from repro_torch.configs import get_arch
from repro_torch.core import split_softmax as ss
from repro_torch.core.attention import AttentionSpec, attention
from repro_torch.core.lut import LUTConfig
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.launch import steps as st
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

TRAIN_STEPS = 20
DECODE_STEPS = 8


def tiny_config() -> ModelConfig:
    """TinyLlama's smoke config in f32, the model of part 3."""
    return get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")


def lut_softmax(rng: np.random.Generator, device) -> Dict:
    """Part 1: the LUT pair's footprint and the LUT split softmax's largest
    error against float safe softmax on (4, 128) scores."""
    print("== LUT split softmax vs float softmax ==")
    z = rng.normal(0, 2.5, (4, 128)).astype(np.float32)
    cfg = LUTConfig(scale_z=float(np.abs(z).max()) / 127)   # calibration
    exp_lut, recip_lut = ss.make_luts(cfg, device=device)
    zt = torch.from_numpy(z).to(device)
    p_float = ss.safe_softmax(zt)
    p_lut = ss.lut_split_softmax_probs(zt, cfg, exp_lut, recip_lut)
    err = float(torch.max(torch.abs(p_lut - p_float)))
    print(f"  LUT pair footprint: {cfg.lut_bytes} bytes")
    print(f"  max |p_lut - p_float| = {err:.5f}")
    return {"lut_bytes": cfg.lut_bytes, "max_err": err}


def attention_modes(rng: np.random.Generator, device) -> Dict:
    """Part 2: one (1, 4, 64, 32) attention with 2 K/V heads in the three
    modes; the drifts of fakequant and int8 from float."""
    print("== attention modes ==")
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape)).to(
        device=device, dtype=torch.float32)
        for shape in ((1, 4, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32)))
    out_f = attention(q, k, v, AttentionSpec(mode="float"))
    out_q = attention(q, k, v, AttentionSpec(mode="fakequant"))
    out_i = attention(q, k, v, AttentionSpec(mode="int8"))
    drift_q = float(torch.max(torch.abs(out_q - out_f)))
    drift_i = float(torch.max(torch.abs(out_i - out_f)))
    print(f"  fakequant vs float drift: {drift_q:.4f}")
    print(f"  int8-LUT  vs float drift: {drift_i:.4f}")
    return {"fakequant_drift": drift_q, "int8_drift": drift_i}


def tiny_train(params, cfg: ModelConfig, device,
               batch_fn: Callable = batch_for_step):
    """Part 3a: ``TRAIN_STEPS`` AdamW steps of QAT (fakequant attention)
    from ``params`` on ``batch_fn(DataConfig, step)``'s batches.  Returns
    the trained parameters, the logged losses (every 5th step) and the
    decode prompt (16 tokens of a held-out batch)."""
    print("== tiny train + int8 decode ==")
    opt_state = adamw.init_state(params)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    step = st.make_train_step(
        cfg, adamw.OptimizerConfig(peak_lr=1e-3, warmup_steps=5,
                                   total_steps=TRAIN_STEPS))
    losses: List[float] = []
    for i in range(TRAIN_STEPS):
        batch = {k: t.to(device) for k, t in batch_fn(dc, i).items()}
        params, opt_state, m = step(params, opt_state, batch)
        if i % 5 == 0:
            losses.append(float(m["loss"]))
            print(f"  step {i:2d} loss {losses[-1]:.4f}")
    prompt = batch_fn(dc, 999)["tokens"][:1, :16]
    return params, losses, prompt


def int8_decode(params, cfg: ModelConfig, device, prompt: torch.Tensor
                ) -> List[int]:
    """Part 3b: ``prompt`` (1, S) prefilled into a dense int8 cache, then
    ``DECODE_STEPS`` greedy decode steps; the greedy tokens."""
    with torch.no_grad():
        cache = T.make_cache(cfg, 1, 64, device=device)
        last, cache = T.prefill(params, prompt.to(device), cfg, cache)
        toks = [int(torch.argmax(last[0, :cfg.vocab_size]))]
        for _ in range(DECODE_STEPS):
            tok = torch.tensor([toks[-1]], dtype=torch.int32, device=device)
            lg, cache = T.decode_step(params, tok, cfg, cache)
            toks.append(int(torch.argmax(lg[0, :cfg.vocab_size])))
    print(f"  greedy continuation (int8 LUT datapath): {toks}")
    return toks


def main(argv=None) -> Dict:
    """Run the three parts; returns their numbers, the trained parameters
    and the decode prompt."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    out = {"lut": lut_softmax(rng, dev), "attention": attention_modes(rng, dev)}
    cfg = tiny_config()
    # drawn on the CPU, so that the card and the CPU start from one model
    params = tu.tree_map(lambda t: t.to(dev),
                         st.init_params_fn(cfg)(seed=0, device="cpu"))
    params, out["losses"], prompt = tiny_train(params, cfg, dev)
    out["tokens"] = int8_decode(params, cfg, dev, prompt)
    out.update(params=params, prompt=prompt)
    return out


if __name__ == "__main__":
    main()
