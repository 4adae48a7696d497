#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, started together);
  3. each kernel against its plain PyTorch version on the card, at the
     serving shapes of TinyLlama-1.1B (Hq 32, Hkv 4, D 64, block_k 32,
     250-token prefill, 8-slot ragged decode) and at edge cases (length 1,
     block boundaries, window, padding mask, an idle slot, block 0 filled
     with 127s); times of the kernel, the plain version, the bound and
     ``F.scaled_dot_product_attention`` as a yardstick (a float softmax, not
     this function; the port never calls it);
  4. the port at the smoke size on the card against the port on the CPU
     (plain versions), on the same random weights;
  5. the main path: churn serving at full TinyLlama-1.1B width (seeded random
     weights, bf16 compute) through ``repro_torch.launch.serve.serve_paged``,
     24 requests over 8 slots, 250-token prompts, gens drawn from [16, 32],
     block_k 32, with every kernel's launch count read around the run.

The line before the last is the card's name and power limit; before it, one
JSON object with each kernel's numbers.  The last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or without the repository beside this script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1.979e15      # H100 SXM dense int8 tensor-core peak

PREFILL = dict(b=1, hq=32, hkv=4, s=250, d=64)
DECODE = dict(b=8, hq=32, hkv=4, d=64, block_k=32, prompt=250, gen=32)
SERVE = dict(requests=24, slots=8, prompt_len=250, gen=32, block_k=32, seed=0)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50, warm: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; inputs stay L2-resident across calls)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tolerance(s_v: float) -> float:
    """f32 sums of e*v taken in another order: bound the difference at
    2e-5 of the output's full scale 127 * s_v (~n * 2^-24 for n <= 300)."""
    return 2e-5 * 127 * s_v


def int8_like(torch, gen, shape, device):
    """Quantized-normal int8 data, as the pool holds."""
    x = torch.randn(shape, generator=gen, device=device) * 40
    return torch.clamp(torch.round(x), -128, 127).to(torch.int8)


# ---------------------------------------------------------------- prefill --

def prefill_phase(torch, F, dev):
    from repro_torch.core import quantization as qlib
    from repro_torch.core.attention import luts_for
    from repro_torch.core.lut import LUTConfig
    from repro_torch.kernels import ops, splitmax_attn as K

    cfg = LUTConfig(scale_z=8.0 / 127)
    exp_lut, recip_lut = luts_for(cfg.scale_z, dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def case(b, hq, hkv, sq, sk, d, *, causal=True, window=None,
             kv_valid=None):
        q = torch.randn((b, hq, sq, d), generator=gen, device=dev)
        k = torch.randn((b, hkv, sk, d), generator=gen, device=dev)
        v = torch.randn((b, hkv, sk, d), generator=gen, device=dev)
        s_q, s_k, s_v = (qlib.absmax_scale(x) for x in (q, k, v))
        args = (qlib.quantize(q, s_q), qlib.quantize(k, s_k),
                qlib.quantize(v, s_v),
                ops.requant_multiplier(s_q, s_k, d, cfg).reshape(()), s_v,
                exp_lut, recip_lut)
        kw = dict(cfg=cfg, causal=causal, window=window, kv_valid_len=kv_valid)
        ker = K.splitmax_attention_cuda(*args, **kw)
        plain = K.splitmax_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((ker - plain).abs().max()) if ker.numel() else 0.0
        tol = tolerance(float(s_v))
        check(bool(torch.isfinite(ker).all()), f"prefill {sq}x{sk}: non-finite")
        check(err <= tol, f"prefill b{b} hq{hq} hkv{hkv} {sq}x{sk} d{d} "
              f"causal={causal} window={window} kv_valid={kv_valid}: "
              f"max|kernel-plain| {err:.3g} > {tol:.3g}")
        return args, kw, err, tol, (q, k, v)

    edges = [
        dict(b=1, hq=32, hkv=4, sq=1, sk=1, d=64),
        dict(b=1, hq=32, hkv=4, sq=32, sk=32, d=64),
        dict(b=1, hq=32, hkv=4, sq=33, sk=33, d=64),
        dict(b=2, hq=8, hkv=2, sq=100, sk=100, d=16),
        dict(b=1, hq=8, hkv=8, sq=100, sk=100, d=64, window=16),
        dict(b=1, hq=4, hkv=1, sq=50, sk=100, d=32, causal=False, kv_valid=70),
    ]
    for e in edges:
        _, _, err, tol, _ = case(**e)
        print(f"[prefill] edge {e}: max_abs_err {err:.3g} (tol {tol:.3g})")

    p = PREFILL
    args, kw, err, tol, (q, k, v) = case(p["b"], p["hq"], p["hkv"], p["s"],
                                         p["s"], p["d"])
    ms = time_ms(torch, lambda: K.splitmax_attention_cuda(*args, **kw))
    plain_ms = time_ms(torch, lambda: K.splitmax_attention_plain(*args, **kw),
                       iters=10)
    g = p["hq"] // p["hkv"]
    kb, vb = (x.to(torch.bfloat16).repeat_interleave(g, dim=1) for x in (k, v))
    qb = q.to(torch.bfloat16)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qb, kb, vb, is_causal=True))
    s = p["s"]
    pairs = p["b"] * p["hq"] * s * (s + 1) // 2          # causal live (q, k)
    n_bytes = (p["b"] * p["hq"] * s * p["d"]             # int8 q
               + 2 * p["b"] * p["hkv"] * s * p["d"]      # int8 k, v
               + 4 * p["b"] * p["hq"] * s * p["d"]       # f32 out
               + 4 * (256 + cfg.recip_table_size))       # LUTs
    # 2D for q.k; 4D for e.V with e (<= 2^15) split into two int8 halves
    bms, by = bound_ms(n_bytes, pairs * 6 * p["d"])
    print(f"[prefill] main {p}: max_abs_err {err:.3g} (tol {tol:.3g}), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms "
          f"({by}), sdpa bf16 yardstick {library_ms:.4f} ms")
    return {"name": "splitmax_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/splitmax_attn.cu",
            "replaces": "src/repro/kernels/splitmax_attn.py:181",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms}


# ----------------------------------------------------------------- decode --

def decode_phase(torch, F, dev):
    from repro_torch.core import paged_kv
    from repro_torch.core import quantization as qlib
    from repro_torch.core.attention import luts_for
    from repro_torch.core.lut import LUTConfig
    from repro_torch.kernels import ops, splitmax_decode as K

    cfg = LUTConfig(scale_z=8.0 / 127)
    exp_lut, recip_lut = luts_for(cfg.scale_z, dev)
    p = DECODE
    gen = torch.Generator(device=dev).manual_seed(2)

    def make(lens, hq, hkv, d, bk, *, idle=()):
        b = len(lens)
        # table rows one entry wider than the longest slot: rows end in trash
        mb = paged_kv.blocks_per_seq(max(lens), bk) + 1
        nb = 1 + b * mb
        kp = int8_like(torch, gen, (nb, hkv, bk, d), dev)
        vp = int8_like(torch, gen, (nb, hkv, bk, d), dev)
        kp[paged_kv.TRASH_BLOCK] = 127                 # poison: any read shows
        vp[paged_kv.TRASH_BLOCK] = 127
        ids = torch.randperm(nb - 1, generator=gen, device=dev) + 1
        table = torch.zeros((b, mb), dtype=torch.int32, device=dev)
        for i, n in enumerate(lens):
            if i not in idle:
                live = paged_kv.blocks_per_seq(n, bk)
                table[i, :live] = ids[i * mb:i * mb + live].to(torch.int32)
        q = torch.randn((b, hq, d), generator=gen, device=dev)
        s_q = qlib.absmax_scale(q, axis=(1, 2)).reshape(-1)
        s_k = torch.tensor(0.021, device=dev)
        s_v = torch.tensor(0.017, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = [q, kp, vp, table, ops.requant_multiplier(s_q, s_k, d, cfg),
                s_q, s_v, lens_t, exp_lut, recip_lut]
        return args

    def compare(args, what, window=None):
        ker = K.splitmax_decode_fused_paged_cuda(*args, cfg=cfg, window=window)
        plain = K.splitmax_decode_fused_paged_plain(*args, cfg=cfg,
                                                    window=window)
        # the trash block must never be read: re-poison it and re-run
        args[1][paged_kv.TRASH_BLOCK] = -77
        args[2][paged_kv.TRASH_BLOCK] = -77
        ker2 = K.splitmax_decode_fused_paged_cuda(*args, cfg=cfg, window=window)
        torch.cuda.synchronize()
        err = float((ker - plain).abs().max())
        tol = tolerance(float(args[6]))
        check(bool(torch.isfinite(ker).all()), f"decode {what}: non-finite")
        check(err <= tol, f"decode {what}: max|kernel-plain| {err:.3g} > "
              f"{tol:.3g}")
        check(torch.equal(ker, ker2), f"decode {what}: output depends on the "
              f"trash block")
        return err, tol

    hq, hkv, d, bk = p["hq"], p["hkv"], p["d"], p["block_k"]
    edge_lens = [1, bk, bk + 1, 2 * bk, 250, 282, 1, 5]
    err, tol = compare(make(edge_lens, hq, hkv, d, bk, idle=(6,)),
                       "edges (len 1, block boundaries, idle slot)")
    print(f"[decode] edges lens {edge_lens} (slot 6 idle): max_abs_err "
          f"{err:.3g} (tol {tol:.3g})")
    err, tol = compare(make([40, 77, 96], 8, 2, 16, 8), "smoke shape d16",
                       window=None)
    print(f"[decode] smoke shape: max_abs_err {err:.3g} (tol {tol:.3g})")
    err, tol = compare(make([100, 64, 33], hq, hkv, d, bk), "window 48",
                       window=48)
    print(f"[decode] window 48: max_abs_err {err:.3g} (tol {tol:.3g})")

    lens = torch.randint(p["prompt"] + 1, p["prompt"] + p["gen"] + 1,
                         (p["b"],), generator=gen, device=dev).tolist()
    args = make(lens, hq, hkv, d, bk)
    err, tol = compare(args, f"main lens {lens}")
    args[1][paged_kv.TRASH_BLOCK] = 127
    args[2][paged_kv.TRASH_BLOCK] = 127
    ms = time_ms(torch, lambda: K.splitmax_decode_fused_paged_cuda(*args,
                                                                     cfg=cfg))
    plain_ms = time_ms(torch, lambda: K.splitmax_decode_fused_paged_plain(
        *args, cfg=cfg), iters=10)
    # yardstick: bf16 SDPA over the same (dense) lengths, GQA expanded
    b, g, smax = p["b"], hq // hkv, max(lens)
    qb = args[0].to(torch.bfloat16)[:, :, None, :]
    kd = torch.randn((b, hq, smax, d), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vd = torch.randn((b, hq, smax, d), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    mask = (torch.arange(smax, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])[:, None, None, :]
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qb, kd, vd, attn_mask=mask))
    total = sum(lens)
    tiles = sum(paged_kv.blocks_per_seq(n, bk) for n in lens)
    n_bytes = (4 * b * hq * d                    # f32 q
               + 2 * hkv * d * total             # int8 k, v at live positions
               + 4 * tiles + 4 * b * 3           # table entries, lens, scales
               + 4 * b * hq * d                  # f32 out
               + 4 * (256 + cfg.recip_table_size))
    bms, by = bound_ms(n_bytes, total * hq * 6 * d)
    print(f"[decode] main lens {lens}: max_abs_err {err:.3g} (tol {tol:.3g}), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms "
          f"({by}), sdpa bf16 yardstick {library_ms:.4f} ms")
    return {"name": "splitmax_decode_fused_paged", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/splitmax_decode.cu",
            "replaces": "src/repro/kernels/splitmax_decode.py:747",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms}


# ------------------------------------------------------- model reference --

def smoke_reference_phase(torch, dev):
    """The port at the smoke size, kernels on the card vs plain versions on
    the CPU, same weights: prefill logits and 8 decode steps."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    cfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    cpu = torch.device("cpu")
    params = T.init_params(cfg, seed=0, device=cpu)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 20))

    def tree_to(tree, device):
        if isinstance(tree, dict):
            return {k: tree_to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [tree_to(v, device) for v in tree]
        return tree.to(device)

    def run(device):
        p = tree_to(params, device)
        cache = T.make_paged_cache(cfg, 1, 40, block_k=8, device=device)
        row = torch.arange(1, 6, dtype=torch.int32, device=device)[None]
        tok = torch.as_tensor(tokens, device=device)
        last, cache = T.prefill_paged(p, tok, cfg, cache,
                                      torch.zeros(1, dtype=torch.int32,
                                                  device=device), row,
                                      calibrate=True)
        outs = [last]
        nxt = torch.argmax(last, -1)
        for _ in range(8):
            logits, cache = T.decode_step(p, nxt, cfg, cache)
            outs.append(logits)
            nxt = torch.argmax(logits, -1)
        return torch.stack(outs).cpu()

    gpu, ref = run(dev), run(cpu)
    err = float((gpu - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(gpu).all()), "smoke model: non-finite logits")
    check(err <= 2e-3 * scale, f"smoke model: max|gpu-cpu| logits {err:.3g} "
          f"> 2e-3 * {scale:.3g}")
    print(f"[model] smoke size, card vs CPU plain path: max|logit diff| "
          f"{err:.3g} (logits up to {scale:.3g}; tol 2e-3 of that)")


# --------------------------------------------------------------- serving --

def serve_phase(torch, dev):
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.kernels import splitmax_attn, splitmax_decode
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    cfg = get_arch("tinyllama_1p1b").config
    params = T.init_params(cfg, seed=SERVE["seed"], device=dev)
    print(f"[serve] {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype} compute), seeded random weights")
    rng = np.random.default_rng(SERVE["seed"])
    prompts = [rng.integers(0, cfg.vocab_size, SERVE["prompt_len"],
                            dtype=np.int32) for _ in range(SERVE["requests"])]
    gens = [int(g) for g in rng.integers(SERVE["gen"] // 2, SERVE["gen"] + 1,
                                         SERVE["requests"])]
    # warm-up: cuBLAS handles and heuristics, allocator pools
    srv.serve_paged(params, cfg, prompts[:2], slots=2, gen=4,
                    block_k=SERVE["block_k"])
    torch.cuda.synchronize()

    splitmax_attn.launches = 0
    splitmax_decode.launches = 0
    stats = srv.serve_paged(params, cfg, prompts, slots=SERVE["slots"],
                            gen=SERVE["gen"], gens=gens,
                            block_k=SERVE["block_k"])
    torch.cuda.synchronize()
    n_prefill, n_decode = splitmax_attn.launches, splitmax_decode.launches

    check(stats["served"] == SERVE["requests"],
          f"served {stats['served']} of {SERVE['requests']}")
    check(stats["leaked_blocks"] == 0, f"{stats['leaked_blocks']} blocks leaked")
    for rid, toks in stats["finished"].items():
        check(len(toks) == gens[rid] and all(0 <= t < cfg.vocab_size
                                             for t in toks),
              f"request {rid}: {len(toks)} tokens, want {gens[rid]} in vocab")
    check(n_prefill == stats["slot_prefills"] * cfg.n_layers,
          f"prefill kernel launches {n_prefill} != {stats['slot_prefills']} "
          f"admissions x {cfg.n_layers} layers")
    check(n_decode == stats["decode_steps"] * cfg.n_layers,
          f"decode kernel launches {n_decode} != {stats['decode_steps']} "
          f"steps x {cfg.n_layers} layers")
    print(f"[serve] churn {SERVE}: served {stats['served']}, "
          f"{stats['total_tokens']} tokens in {stats['wall_s']:.3f} s, "
          f"{stats['tok_s']:.1f} tok/s, {stats['decode_steps']} decode steps, "
          f"p50/p99 step {stats['p50_step_ms']:.2f}/"
          f"{stats['p99_step_ms']:.2f} ms, leaked {stats['leaked_blocks']}, "
          f"launches prefill {n_prefill} decode {n_decode}")
    profile_serving(torch, srv, params, cfg, prompts[:SERVE["slots"]])
    return {"splitmax_attention": n_prefill,
            "splitmax_decode_fused_paged": n_decode}


def profile_serving(torch, srv, params, cfg, prompts, gen: int = 8):
    """Where the time goes: one full batch (8 admissions, then decode steps)
    under torch.profiler; device busy share and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = srv.serve_paged(params, cfg, prompts, slots=len(prompts),
                                gen=gen, block_k=SERVE["block_k"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernel and memcpy events only: a CPU op's device time is
    # its kernels' time again
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in rows)
    check(busy_ms > 0, "profiler saw no device time")
    rows.sort(key=lambda r: -r[2])
    print(f"[profile] {len(prompts)} admissions + {stats['decode_steps']} "
          f"decode steps under the profiler: wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for key, count, ms in rows[:10]:
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  "
              f"x{count:<5d} {key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import torch.nn.functional as F
    from repro_torch import resolve_device
    from repro_torch.kernels import cuda_build

    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    dev = resolve_device("cuda")

    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"[build] {sorted(cuda_build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    kernels = [prefill_phase(torch, F, dev), decode_phase(torch, F, dev)]
    smoke_reference_phase(torch, dev)
    launches = serve_phase(torch, dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} never launched on the main path")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
