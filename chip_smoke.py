#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, started together);
  3. each kernel against its plain PyTorch version on the card, at the
     serving shapes of TinyLlama-1.1B (Hq 32, Hkv 4, D 64, block_k 32,
     250-token prefill, 8-slot ragged decode, gamma 4 and 8 verify) and at
     edge cases (length 1 or gamma, block boundaries, window, padding mask,
     an idle slot, block 0 filled with 127 and then -77); every verify row
     bit for bit the decode kernel at its effective length, and the composed
     decode bit for bit the fused one; times of the kernel, the plain
     version, the bound and yardsticks (``F.scaled_dot_product_attention``,
     a float softmax and not this function, which the port never calls;
     for verify also gamma decode launches, what one verify replaces);
  4. the port at the smoke size on the card against the port on the CPU
     (plain versions), on the same random weights, and smoke-size f32
     speculative serving on the card against plain serving, token for token;
  5. the main paths at full TinyLlama-1.1B width (seeded random weights,
     bf16 compute), each with the kernels' launch counts set to 0 just
     before it and read just after:
       a. churn serving through ``serve_paged``: 24 requests over 8 slots,
          250-token prompts, gens drawn from [16, 32], block_k 32;
       b. whether a GEMM or RMSNorm row depends on the number of rows
          (decode runs B, verify B * gamma), then the same churn through
          ``serve_speculative`` with the target as drafter and with its
          first 4 layers, gamma 4;
       c. the first 8 churn requests through the composed decode
          (``attn_fused=False``) and the fused one.

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
VERIFY = dict(b=8, hq=32, hkv=4, d=64, block_k=32, lens=(251, 282),
              gammas=(4, 8))
SERVE = dict(requests=24, slots=8, prompt_len=250, gen=32, block_k=32, seed=0)
SPEC = dict(gamma=4, prefix_layers=4)
COMPOSED_REQUESTS = 8


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


def paged_case(torch, gen, dev, lens, hkv, d, bk, *, idle=()):
    """A shuffled int8 pool and table for slots of ``lens``: rows one entry
    wider than the longest slot (they end in trash), block 0 poisoned with
    127 so that any read of it shows, ``idle`` slots owning no block."""
    from repro_torch.core import paged_kv
    b = len(lens)
    mb = paged_kv.blocks_per_seq(max(lens), bk) + 1
    nb = 1 + b * mb
    kp = int8_like(torch, gen, (nb, hkv, bk, d), dev)
    vp = int8_like(torch, gen, (nb, hkv, bk, d), dev)
    kp[paged_kv.TRASH_BLOCK] = 127
    vp[paged_kv.TRASH_BLOCK] = 127
    ids = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    table = torch.zeros((b, mb), dtype=torch.int32, device=dev)
    for i, n in enumerate(lens):
        if i not in idle:
            live = paged_kv.blocks_per_seq(n, bk)
            table[i, :live] = ids[i * mb:i * mb + live].to(torch.int32)
    return kp, vp, table, torch.tensor(lens, dtype=torch.int32, device=dev)


def pool_scales(torch, dev):
    """The pool's static (s_k, s_v) of the kernel phases."""
    return torch.tensor(0.021, device=dev), torch.tensor(0.017, device=dev)


def sdpa_decode_yardstick(torch, F, gen, dev, b, hq, d, q_lens):
    """bf16 SDPA over dense K/V of the same lengths, GQA expanded: ``q_lens
    (b, T)`` is each query's visible length.  Returns its time in ms."""
    t = len(q_lens[0])
    smax = max(max(row) for row in q_lens)
    qb = torch.randn((b, hq, t, d), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    kd = torch.randn((b, hq, smax, d), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vd = torch.randn((b, hq, smax, d), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    mask = (torch.arange(smax, device=dev)[None, None, :]
            < torch.tensor(q_lens, device=dev)[:, :, None])[:, None]
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        qb, kd, vd, attn_mask=mask))


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
        kp, vp, table, lens_t = paged_case(torch, gen, dev, lens, hkv, d, bk,
                                           idle=idle)
        q = torch.randn((b, hq, d), generator=gen, device=dev)
        s_q = qlib.absmax_scale(q, axis=(1, 2)).reshape(-1)
        s_k, s_v = pool_scales(torch, dev)
        return [q, kp, vp, table, ops.requant_multiplier(s_q, s_k, d, cfg),
                s_q, s_v, lens_t, exp_lut, recip_lut]

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
    b = p["b"]
    library_ms = sdpa_decode_yardstick(torch, F, gen, dev, b, hq, d,
                                       [[n] for n in lens])
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
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms}, args


# ----------------------------------------------------------------- verify --

def verify_phase(torch, F, dev, decode_ms):
    from repro_torch.core import paged_kv
    from repro_torch.core import quantization as qlib
    from repro_torch.core.attention import luts_for
    from repro_torch.core.lut import LUTConfig
    from repro_torch.kernels import ops, splitmax_decode as K

    cfg = LUTConfig(scale_z=8.0 / 127)
    exp_lut, recip_lut = luts_for(cfg.scale_z, dev)
    p = VERIFY
    hq, hkv, d, bk = p["hq"], p["hkv"], p["d"], p["block_k"]
    gen = torch.Generator(device=dev).manual_seed(4)

    def case(lens, gamma, what, *, window=None, idle=()):
        b = len(lens)
        kp, vp, table, lens_t = paged_case(torch, gen, dev, lens, hkv, d, bk,
                                           idle=idle)
        q = torch.randn((b, hq, gamma, d), generator=gen, device=dev)
        s_q = qlib.absmax_scale(q, axis=(1, 3))[:, 0, :, 0].contiguous()
        s_k, s_v = pool_scales(torch, dev)
        m_z = ops.requant_multiplier(s_q, s_k, d, cfg)
        args = [q, kp, vp, table, m_z, s_q, s_v, lens_t, exp_lut, recip_lut]
        ker = K.splitmax_decode_fused_verify_paged_cuda(*args, cfg=cfg,
                                                        window=window)
        plain = K.splitmax_decode_fused_verify_paged_plain(*args, cfg=cfg,
                                                           window=window)
        # each row is the decode kernel at its effective length, bit for bit
        rows = [[q[:, :, t].contiguous(), kp, vp, table,
                 m_z[:, t].contiguous(), s_q[:, t].contiguous(), args[6],
                 lens_t - (gamma - 1 - t), exp_lut, recip_lut]
                for t in range(gamma)]
        for t, row in enumerate(rows):
            dec = K.splitmax_decode_fused_paged_cuda(*row, cfg=cfg,
                                                     window=window)
            check(torch.equal(ker[:, :, t], dec), f"verify {what}: token {t} "
                  f"differs from the decode kernel at its effective length")
        kp[paged_kv.TRASH_BLOCK] = -77
        vp[paged_kv.TRASH_BLOCK] = -77
        ker2 = K.splitmax_decode_fused_verify_paged_cuda(*args, cfg=cfg,
                                                         window=window)
        torch.cuda.synchronize()
        err = float((ker - plain).abs().max())
        tol = tolerance(float(args[6]))
        check(bool(torch.isfinite(ker).all()), f"verify {what}: non-finite")
        check(err <= tol, f"verify {what}: max|kernel-plain| {err:.3g} > "
              f"{tol:.3g}")
        check(torch.equal(ker, ker2), f"verify {what}: output depends on the "
              f"trash block")
        for i in idle:
            check(not ker[i].any(), f"verify {what}: idle slot {i} not zero")
        print(f"[verify] {what}: lens {lens}, gamma {gamma}, window {window}: "
              f"max_abs_err {err:.3g} (tol {tol:.3g}), rows == decode kernel")
        return args, rows, err, tol

    for gamma in p["gammas"]:
        # token 0 sees one position; slot 2's tokens straddle the 2*bk
        # boundary; slot 4 idle; a window cutting into the tiles
        edges = [gamma, bk, 2 * bk + gamma // 2, 250, gamma, 282, 96, 33]
        case(edges, gamma, "edges", idle=(4,))
        case(edges, gamma, "edges window 48", window=48, idle=(4,))
    case([40, 77, 96], 4, "smoke-width heads d 64")

    results = []
    for gamma in p["gammas"]:
        lens = torch.randint(p["lens"][0], p["lens"][1] + 1, (p["b"],),
                             generator=gen, device=dev).tolist()
        args, rows, err, tol = case(lens, gamma, "main")
        args[1][paged_kv.TRASH_BLOCK] = 127
        args[2][paged_kv.TRASH_BLOCK] = 127
        ms = time_ms(torch, lambda: K.splitmax_decode_fused_verify_paged_cuda(
            *args, cfg=cfg))
        plain_ms = time_ms(torch, lambda: K.splitmax_decode_fused_verify_paged_plain(
            *args, cfg=cfg), iters=10)

        def decodes():
            for row in rows:
                K.splitmax_decode_fused_paged_cuda(*row, cfg=cfg)

        decodes_ms = time_ms(torch, decodes)
        b = p["b"]
        q_lens = [[n - (gamma - 1 - t) for t in range(gamma)] for n in lens]
        library_ms = sdpa_decode_yardstick(torch, F, gen, dev, b, hq, d,
                                           q_lens)
        tiles = sum(paged_kv.blocks_per_seq(n, bk) for n in lens)
        pairs = hq * sum(sum(row) for row in q_lens)    # live (query, key)
        n_bytes = (4 * b * hq * gamma * d           # f32 q
                   + 2 * hkv * d * sum(lens)        # int8 k, v, read once
                   + 4 * tiles + 4 * b              # table entries, lens
                   + 2 * 4 * b * gamma + 4          # m_z, s_q, s_v
                   + 4 * b * hq * gamma * d         # f32 out
                   + 4 * (256 + cfg.recip_table_size))
        bms, by = bound_ms(n_bytes, pairs * 6 * d)
        print(f"[verify] main gamma {gamma}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by}), {gamma} decode "
              f"launches {decodes_ms:.4f} ms (decode phase: {gamma} x "
              f"{decode_ms:.4f} = {gamma * decode_ms:.4f} ms), sdpa bf16 "
              f"{gamma}-query masked yardstick {library_ms:.4f} ms")
        results.append({
            "name": "splitmax_decode_fused_verify_paged", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/splitmax_verify.cu",
            "replaces": "src/repro/kernels/splitmax_decode.py:820",
            "gamma": gamma, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "decodes_ms": decodes_ms})
    # the serving path runs gamma = SPEC["gamma"]: its row goes in the line
    return next(r for r in results if r["gamma"] == SPEC["gamma"])


# --------------------------------------------------------------- composed --

def composed_phase(torch, F, dev, decode_args):
    """Kernel 5 on the decode phase's main inputs: int8 q from
    quantize(q, s_q) on the card, then the composed kernel, which must
    equal the fused kernel bit for bit and the plain version within
    tolerance."""
    from repro_torch.core import paged_kv
    from repro_torch.core import quantization as qlib
    from repro_torch.core.lut import LUTConfig
    from repro_torch.kernels import splitmax_decode as K

    cfg = LUTConfig(scale_z=8.0 / 127)
    gen = torch.Generator(device=dev).manual_seed(5)
    q, kp, vp, table, m_z, s_q, s_v, lens_t, exp_lut, recip_lut = decode_args
    q_q = qlib.quantize(q, s_q[:, None, None])
    args = [q_q, kp, vp, table, m_z, s_v, lens_t, exp_lut, recip_lut]
    errs = []
    for window in (None, 48):
        ker = K.splitmax_decode_paged_cuda(*args, cfg=cfg, window=window)
        fused = K.splitmax_decode_fused_paged_cuda(*decode_args, cfg=cfg,
                                                   window=window)
        plain = K.splitmax_decode_paged_plain(*args, cfg=cfg, window=window)
        kp[paged_kv.TRASH_BLOCK] = -77
        vp[paged_kv.TRASH_BLOCK] = -77
        ker2 = K.splitmax_decode_paged_cuda(*args, cfg=cfg, window=window)
        kp[paged_kv.TRASH_BLOCK] = 127
        vp[paged_kv.TRASH_BLOCK] = 127
        torch.cuda.synchronize()
        err = float((ker - plain).abs().max())
        tol = tolerance(float(s_v))
        check(err <= tol, f"composed window {window}: max|kernel-plain| "
              f"{err:.3g} > {tol:.3g}")
        check(torch.equal(ker, fused), f"composed window {window}: differs "
              f"from the fused kernel on quantize(q, s_q)")
        check(torch.equal(ker, ker2), f"composed window {window}: output "
              f"depends on the trash block")
        errs.append(err)
        print(f"[composed] window {window}: max_abs_err {err:.3g} (tol "
              f"{tol:.3g}), == fused kernel bit for bit")
    ms = time_ms(torch, lambda: K.splitmax_decode_paged_cuda(*args, cfg=cfg))
    plain_ms = time_ms(torch, lambda: K.splitmax_decode_paged_plain(
        *args, cfg=cfg), iters=10)
    b, hq, d = q.shape
    hkv, bk = kp.shape[1], kp.shape[2]
    lens = lens_t.tolist()
    library_ms = sdpa_decode_yardstick(torch, F, gen, dev, b, hq, d,
                                       [[n] for n in lens])
    tiles = sum(paged_kv.blocks_per_seq(n, bk) for n in lens)
    n_bytes = (b * hq * d                       # int8 q
               + 2 * hkv * d * sum(lens)        # int8 k, v at live positions
               + 4 * tiles + 4 * b * 2 + 4      # table, lens, m_z, s_v
               + 4 * b * hq * d                 # f32 out
               + 4 * (256 + cfg.recip_table_size))
    bms, by = bound_ms(n_bytes, sum(lens) * hq * 6 * d)
    print(f"[composed] main lens {lens}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by}), sdpa bf16 "
          f"yardstick {library_ms:.4f} ms")
    return {"name": "splitmax_decode_paged", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/splitmax_decode.cu",
            "replaces": "src/repro/kernels/splitmax_decode.py:709",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms}


# ------------------------------------------------------- model reference --

def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def smoke_reference_phase(torch, dev):
    """The port at the smoke size, kernels on the card vs plain versions on
    the CPU, same weights: prefill logits and 8 decode steps.  Then f32
    speculative serving on the card against plain serving on the card,
    token for token (TF32 is off: ``resolve_device``)."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    cfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    cpu = torch.device("cpu")
    params = T.init_params(cfg, seed=0, device=cpu)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 20))

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

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 20, dtype=np.int32)
               for _ in range(6)]
    gens = [int(g) for g in rng.integers(6, 13, 6)]
    p = tree_to(params, dev)
    plain = srv.serve_paged(p, cfg, prompts, slots=3, gen=12, gens=gens,
                            block_k=8)
    for name, draft in (("self", "self"), ("self:1", srv.make_self_draft(
            p, cfg, 1))):
        for gamma in (2, 4):
            spec = srv.serve(p, cfg, prompts, slots=3, gen=12, gens=gens,
                             block_k=8, draft=draft, gamma=gamma)
            check(spec["finished"] == plain["finished"],
                  f"smoke f32 speculative ({name}, gamma {gamma}) tokens "
                  f"differ from plain serving on the card")
            check(spec["leaked_blocks"] == 0, "smoke speculative leaked")
    print("[model] smoke size f32 on the card: speculative tokens (self, "
          "self:1; gamma 2, 4) == plain tokens")


# --------------------------------------------------------------- serving --

def churn(cfg):
    """The churn workload: SERVE's prompts and staggered gens, seed 0."""
    import numpy as np
    rng = np.random.default_rng(SERVE["seed"])
    prompts = [rng.integers(0, cfg.vocab_size, SERVE["prompt_len"],
                            dtype=np.int32) for _ in range(SERVE["requests"])]
    gens = [int(g) for g in rng.integers(SERVE["gen"] // 2, SERVE["gen"] + 1,
                                         SERVE["requests"])]
    return prompts, gens


def check_served(stats, gens, vocab, what):
    check(stats["served"] == len(gens),
          f"{what}: served {stats['served']} of {len(gens)}")
    check(stats["leaked_blocks"] == 0,
          f"{what}: {stats['leaked_blocks']} blocks leaked")
    check(not stats.get("failed"), f"{what}: failed {stats.get('failed')}")
    for rid, toks in stats["finished"].items():
        check(len(toks) == gens[rid] and all(0 <= t < vocab for t in toks),
              f"{what}: request {rid}: {len(toks)} tokens, want {gens[rid]} "
              f"in vocab")


def serve_phase(torch, dev, params, cfg):
    from repro_torch.kernels import splitmax_attn, splitmax_decode
    from repro_torch.launch import serve as srv

    prompts, gens = churn(cfg)
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

    check_served(stats, gens, cfg.vocab_size, "plain churn")
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
    return stats, {"splitmax_attention": n_prefill,
                   "splitmax_decode_fused_paged": n_decode}


def rows_agree(torch, dev, params, cfg, b: int, t: int) -> bool:
    """Whether a row's result depends on the number of rows it is computed
    with: decode runs B rows, verify B * T.  For each linear weight of layer
    0 in the compute dtype, ``x[:B] @ W`` against the first B rows of
    ``x @ W`` at M = B * T; verify runs these GEMMs on all B * T rows, so
    the answer decides whether full-width tokens must equal.  The RMSNorm
    and the f32 LM head are shown too: verify runs them one token at a
    time, at the decode step's shape, because their rows do depend on it."""
    gen = torch.Generator(device=dev).manual_seed(6)
    lp = params["layers"][0]
    weights = [("wq", lp["attn"]["wq"]["w"]), ("wk", lp["attn"]["wk"]["w"]),
               ("wv", lp["attn"]["wv"]["w"]), ("wo", lp["attn"]["wo"]["w"]),
               ("w_in", lp["mlp"]["w_in"]["w"]),
               ("w_gate", lp["mlp"]["w_gate"]["w"]),
               ("w_out", lp["mlp"]["w_out"]["w"]),
               ("lm_head", params["lm_head"]["w"])]
    verdicts = []
    for name, w in weights:
        w = w.to(torch.float32 if name == "lm_head" else cfg.compute_dtype)
        x = torch.randn((b * t, w.shape[0]), generator=gen, device=dev
                        ).to(w.dtype)
        small, big = x[:b] @ w, (x @ w)[:b]
        same = torch.equal(small, big)
        if name != "lm_head":
            verdicts.append(same)
        print(f"[rows] {name} {tuple(w.shape)} {w.dtype}: rows at M={b} "
              f"{'==' if same else '!='} rows at M={b * t} (max diff "
              f"{float((small.float() - big.float()).abs().max()):.3g})"
              + ("; verify runs it per token" if name == "lm_head" else ""))
    # the RMSNorm's f32 mean of squares, per token slice vs all tokens
    x = torch.randn((b, t, cfg.d_model), generator=gen, device=dev)
    small = torch.cat([torch.mean(torch.square(x[:, i:i + 1].contiguous()),
                                  dim=-1) for i in range(t)], dim=1)
    big = torch.mean(torch.square(x), dim=-1)
    print(f"[rows] rmsnorm mean of squares: ({b}, 1, {cfg.d_model}) slices "
          f"{'==' if torch.equal(small, big) else '!='} ({b}, {t}, "
          f"{cfg.d_model}) ({int((small != big).sum())} of {b * t} rows "
          f"differ); verify runs the norms per token")
    return all(verdicts)


def spec_serve_phase(torch, dev, params, cfg, plain):
    """The churn through serve_speculative, self-drafted and drafted by the
    target's first layers; launch counts read around each run."""
    from repro_torch.kernels import splitmax_attn, splitmax_decode as K
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    prompts, gens = churn(cfg)
    gamma = SPEC["gamma"]
    agree = rows_agree(torch, dev, T.cast_for_serving(params, cfg), cfg,
                       SERVE["slots"], gamma)
    # warm-up: the verify GEMM shapes (M = slots * gamma)
    srv.serve(params, cfg, prompts[:2], slots=2, gen=4, gamma=gamma,
              draft="self", block_k=SERVE["block_k"])
    torch.cuda.synchronize()
    n_verify = 0
    for name, draft in (("self", None), (f"self:{SPEC['prefix_layers']}",
                                         srv.make_self_draft(
                                             params, cfg,
                                             SPEC["prefix_layers"]))):
        d_layers = cfg.n_layers if draft is None else draft[1].n_layers
        splitmax_attn.launches = K.launches = K.verify_launches = 0
        stats = srv.serve_speculative(
            params, cfg, prompts, slots=SERVE["slots"], gen=SERVE["gen"],
            gens=gens, gamma=gamma, draft=draft, block_k=SERVE["block_k"])
        torch.cuda.synchronize()
        n_pre, n_dec, n_ver = (splitmax_attn.launches, K.launches,
                               K.verify_launches)
        what = f"speculative {name}"
        check_served(stats, gens, cfg.vocab_size, what)
        admissions = stats["slot_prefills"] // (1 if draft is None else 2)
        check(n_ver == stats["verify_steps"] * cfg.n_layers,
              f"{what}: verify launches {n_ver} != {stats['verify_steps']} "
              f"rounds x {cfg.n_layers}")
        check(n_dec == stats["draft_steps"] * gamma * d_layers,
              f"{what}: decode launches {n_dec} != {stats['draft_steps']} x "
              f"{gamma} x {d_layers}")
        want_pre = admissions * cfg.n_layers + (
            0 if draft is None else admissions * d_layers)
        check(n_pre == want_pre, f"{what}: prefill launches {n_pre} != "
              f"{want_pre}")
        same = sum(stats["finished"][r] == plain["finished"][r]
                   for r in plain["finished"])
        share = same / len(plain["finished"])
        if agree:
            check(share == 1.0, f"{what}: tokens differ from plain serving "
                  f"in {len(plain['finished']) - same} requests")
        print(f"[spec] {what} gamma {gamma}: served {stats['served']}, "
              f"{stats['total_tokens']} tokens in {stats['wall_s']:.3f} s, "
              f"{stats['tok_s']:.1f} tok/s (plain {plain['tok_s']:.1f}), "
              f"{stats['verify_steps']} rounds, p50/p99 round "
              f"{stats['p50_step_ms']:.2f}/{stats['p99_step_ms']:.2f} ms, "
              f"accept_rate {stats['accept_rate']:.4f}, tokens_per_verify "
              f"{stats['tokens_per_verify']:.3f}, agreement with plain "
              f"tokens {share:.4f} ({same}/{len(plain['finished'])}), leaked "
              f"{stats['leaked_blocks']}, launches prefill {n_pre} decode "
              f"{n_dec} verify {n_ver}")
        n_verify += n_ver
    return n_verify


def composed_serve_phase(torch, dev, params, cfg):
    """The first churn requests through the composed decode and the fused
    one: equal tokens, one composed launch per layer and step."""
    from repro_torch.kernels import splitmax_decode as K
    from repro_torch.launch import serve as srv

    prompts, gens = churn(cfg)
    prompts, gens = prompts[:COMPOSED_REQUESTS], gens[:COMPOSED_REQUESTS]
    kw = dict(slots=SERVE["slots"], gen=SERVE["gen"], gens=gens,
              block_k=SERVE["block_k"])
    K.launches = K.composed_launches = 0
    comp = srv.serve_paged(params, cfg.replace(attn_fused=False), prompts,
                           **kw)
    torch.cuda.synchronize()
    n_comp, n_fused = K.composed_launches, K.launches
    fused = srv.serve_paged(params, cfg, prompts, **kw)
    check_served(comp, gens, cfg.vocab_size, "composed serve")
    check(n_comp == comp["decode_steps"] * cfg.n_layers and n_fused == 0,
          f"composed launches {n_comp} (fused {n_fused}) != "
          f"{comp['decode_steps']} steps x {cfg.n_layers}")
    check(comp["finished"] == fused["finished"],
          "composed serving tokens differ from fused serving")
    print(f"[composed-serve] {len(prompts)} requests: composed "
          f"{comp['tok_s']:.1f} tok/s, p50 step {comp['p50_step_ms']:.2f} ms; "
          f"fused {fused['tok_s']:.1f} tok/s, p50 step "
          f"{fused['p50_step_ms']:.2f} ms; tokens equal; composed launches "
          f"{n_comp}")
    return n_comp


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

    decode, decode_args = decode_phase(torch, F, dev)
    kernels = [prefill_phase(torch, F, dev), decode,
               verify_phase(torch, F, dev, decode["ms"]),
               composed_phase(torch, F, dev, decode_args)]
    smoke_reference_phase(torch, dev)

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch("tinyllama_1p1b").config
    params = T.init_params(cfg, seed=SERVE["seed"], device=dev)
    print(f"[serve] {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype} compute), seeded random weights")
    plain, launches = serve_phase(torch, dev, params, cfg)
    launches["splitmax_decode_fused_verify_paged"] = spec_serve_phase(
        torch, dev, params, cfg, plain)
    launches["splitmax_decode_paged"] = composed_serve_phase(torch, dev,
                                                             params, cfg)
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
