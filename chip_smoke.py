#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, started together);
  3. each kernel against its plain PyTorch version on the card, at the
     serving shapes of TinyLlama-1.1B (Hq 32, Hkv 4, D 64, block_k 32,
     250-token prefill and the dense path's 8 x 282 re-prefill, 8-slot
     ragged decode over the pool and over a 290-position dense cache,
     gamma 4 and 8 verify over both, and the verify at group 8 with gamma
     16 at D 64 and gamma 8 at D 128), at DeepSeekMoE-16B's (16/16 heads,
     MHA at D 128: its 250-token prefill, 8-slot decode and gamma 4
     verify), at the dense family's GQA groups at D 128 (Mistral-NeMo-12B's
     32/8 heads, group 4; DeepSeek-Coder-33B's 56/8, group 7: the same
     three shapes) and at edge cases (length 0, 1 or
     gamma, tile boundaries, window, padding mask, an idle slot, a dense
     cache no tile divides, block 0 filled with 127 and then -77); every
     split-softmax kernel bit for bit its plain version's ``exact=True``
     (the kernels' exact integer sums) and within ``tolerance`` of the
     default plain version; every verify row bit for bit the decode kernel
     at its effective length, the composed decodes bit for bit the fused
     ones, and the dense decode bit for bit the paged one on the same K/V;
     the int8 GEMM bit for bit at the reference's shapes, a ragged one and
     TinyLlama's widths; the plain version's time and the kernel's
     host-inclusive time (back-to-back Python calls) and bound; then the
     kernels' two options on each split-softmax kernel's main inputs: its
     ``exact_recip`` instance bit for bit the plain version's ``exact=True``
     with ``exact_recip``, within ``tolerance`` of the default plain
     version and within the reference's 2^-8 of the LUT instance; and the
     kernel reading the ``lut_mode="compute"`` table bit for bit the plain
     version on that table;
  4. device times: each kernel at its main shape (and its ``exact_recip``
     instance, and the MoE and dense-family shapes) and its yardsticks
     (``F.scaled_dot_product_attention``, a float softmax and not this
     function, which the port never calls; for verify also the gamma decode
     launches one verify replaces; ``torch._int_mm`` for the GEMM) captured
     50 calls to a CUDA graph and replayed, 7 rounds interleaved, median
     and min-max, beside the launch floor (a replayed one-element add_);
     the GEMM and its yardsticks also L2-cold, each captured call on its
     own copy of the operands;
  5. the port at the smoke size on the card against the port on the CPU
     (plain versions), on the same random weights: paged prefill + decode
     logits, a sliding-window ring-buffer config's logits, and dense
     serving tokens (fused and composed); then smoke-size f32 speculative
     serving on the card against plain serving, token for token;
  6. the main paths at full TinyLlama-1.1B width (seeded random weights,
     bf16 compute), each with the kernels' launch counts set to 0 just
     before it and read just after:
       a. churn serving through ``serve_paged``: 24 requests over 8 slots,
          250-token prompts, gens drawn from [16, 32], block_k 32;
       b. whether a GEMM or RMSNorm row depends on the number of rows
          (decode runs B, verify B * gamma; a record: verify runs them all
          one token at a time), ``verify_step``'s logits bit for bit
          ``decode_step``'s, then the same churn through
          ``serve_speculative`` with the target as drafter and with its
          first 4 layers, gamma 4 (the plain tokens);
       c. the first 8 churn requests through the composed decode
          (``attn_fused=False``) and the fused one;
       d. the same churn through ``serve_dense`` (``--cache dense``), in
          turns with ``serve_paged`` (dense, paged, dense), then its first
          8 requests through the composed and the fused dense decode;
       e. pressure: the churn over a pool of 5 sequences (51 blocks) under
          both preemption policies, the plain churn's tokens bit for bit
          through preemption, re-prefill and replay;
       f. chaos: pool exhaustion, a 0.3 s scheduler delay and a NaN slot
          with a step deadline and the metrics document, through
          ``serve_paged`` and ``serve_speculative`` (self-drafted, and by
          the first 4 layers on a second pool): every request accounted
          for, the faulted run's finished tokens the plain churn's, no leak;
       g. sampled: temperature 0.8, top_p 0.95, seed 3, twice with a full
          pool and once under pressure (equal tokens), seed 4 (other
          tokens), top_p 1e-9 (the greedy tokens).
       Phase a runs with ``warmup=True`` and checks that ``repeats=2``
       keeps the first run's tokens.
  7. QAT training (fakequant attention, AdamW), at the smoke size in f32:
     the card against the CPU over 5 steps (losses and grad norms within
     1e-3), the same step twice bit for bit, the CLI's resume (3 steps,
     a checkpoint, 3 more) bit for bit against 6 straight, and the
     reference's fakequant->int8 check after 30 steps (top-1 agreement >
     0.9, TV < 0.1); then at full TinyLlama-1.1B width, 8 steps of B 4 x
     2048 through ``launch.train.main`` (step ms, tok/s, MFU, peak memory;
     loss finite and falling), the fakequant->int8 check of the trained
     weights at B 1 x 2048 (kernel 1, counted), one layer's fakequant
     attention timed alone, and one step under the profiler whose loss and
     grad norm repeat the run's first bit for bit.  Kernel 1 is also held
     against its exact plain version and timed at B 1 x 2048 in phases 3
     and 4.
  8. the MoE family: both MoE smoke configs (DeepSeekMoE, Mixtral) in f32
     on the card against the CPU (paged prefill + 8 decode steps within
     2e-3 of the logits' scale, a small churn's tokens equal); then
     DeepSeekMoE-16B at full width (28 layers, d_model 2048, 64 experts,
     top-6, 2 shared; seeded random weights drawn on the card leaf by leaf
     in bf16), once the training phases' memory is freed: the churn
     through ``serve_paged`` with ``warmup=True`` (launch counts as in
     6a), one batch under the profiler, the row-count check, the churn
     through ``serve_speculative`` self-drafted at gamma 4 (tokens those of
     the plain churn, kernel 3 counted), and layer 1 on one prompt against
     an f32 recomputation on the card (routing and dropped set equal
     outside near-ties, output within a stated bf16 tolerance).
  9. the rest of the dense family: the five smoke configs (OLMo-1B,
     Mistral-NeMo-12B, Chameleon-34B, DeepSeek-Coder-33B, DeepSeek-67B) in
     f32 on the card against the CPU as in phase 8; then Mistral-NeMo-12B
     at full width (40 layers, d_model 5120, 32/8 heads of 128, d_ff
     14336, vocab 131072; seeded random bf16 weights drawn leaf by leaf,
     the LM head f32): the churn through ``serve_paged`` with
     ``warmup=True``, one profiled batch, the row-count check, and the
     churn through ``serve_speculative`` self-drafted at gamma 4 (tokens
     those of the plain churn where the row check says they must be); and
     OLMo-1B at full width (non-parametric LayerNorm, the tied f32 head):
     the plain churn.  Each prints its seconds.
 10. the encoder-decoder family: SeamlessM4T-medium's smoke config in f32 on
     the card against the CPU (paged, with the carved cross bank, and
     dense-cache prefill + 8 decode steps within 2e-3 of the logits' scale;
     a 6-request churn's tokens equal, fused and composed); then
     SeamlessM4T-medium at full width (12 encoder + 12 decoder layers,
     d_model 1024, 16/16 heads of 64, d_ff 4096, GELU, LayerNorm, vocab
     256206 tied; seeded random bf16 weights drawn leaf by leaf, the table
     f32): the churn with 250 x 1024 encoder frames a request through
     ``serve_paged`` with ``warmup=True`` (kernel 1 three times a layer an
     admission, kernel 2 twice a layer a step: counted), the composed churn
     and a pressure churn over a 51-block dynamic pool with the carved bank
     on top (both the plain tokens; every pool ends empty), one profiled
     batch, and kernel 1 at its encoder (bidirectional), self (causal) and
     cross (250 x 250 and 250 x 1024) shapes and kernels 2 and 5 over the
     8-slot carved bank, each bit for bit its exact plain version and timed
     beside its bound and SDPA (``"seamless"`` in the JSON line).
 11. the SSM and hybrid families: both smoke configs in f32 on the card
     against the CPU (dense-cache prefill + 8 decode steps within 2e-3 of
     the logits' scale, Falcon-Mamba's also through the int8 state-slab
     engine; a 6-request churn's tokens equal: Falcon-Mamba paged and
     dense, Zamba2 dense fused and composed); then Falcon-Mamba-7B at full
     width (64 Mamba-1 layers, d_model 4096, d_inner 8192, d_state 16;
     seeded random bf16 weights drawn leaf by leaf, the untied LM head
     f32): the churn through the state-slab engine with ``warmup=True``
     (no split-softmax launch: an SSM has no softmax), under a forced
     preemption (the plain tokens, 1 preemption and 1 resume), through
     ``--cache dense``, and one profiled batch, with peak memory and the
     slabs' bytes; and Zamba2-2.7B at full width (54 Mamba-2 layers,
     d_model 2560, one shared attention block of 32/32 heads of 80 nine
     times a token, the tied f32 table): the churn through ``serve_dense``
     with ``warmup=True``, fused (kernels 1 and 4) and composed (kernels 1
     and 6; the fused tokens), one profiled batch, and kernel 1 at B 8 x
     250 and B 8 x 282 and kernels 4 and 6 over the B 8 x 290 dense cache
     at D 80, each bit for bit its exact plain version and timed beside
     its bound and SDPA (``"zamba2"`` in the JSON line).

 12. int8 serve weights, the CIM model and the decode baselines: the
     smoke configs of the dense, MoE, encoder-decoder and hybrid families
     served with int8 weights (``serve_param_dtype="int8"``) on the card
     against the CPU, equal tokens, and Falcon-Mamba's Mamba-1 layers
     refused (``ValueError``) by the serving init and by ``serve``; the
     float and fakequant decode baselines on TinyLlama's smoke config, the
     card against the CPU (logits within ``DECODE_BASELINE_TOL`` of their
     scale, equal tokens, no split-softmax launch); DeepSeek-67B at full
     width in int8 (95 layers, d_model 8192, 64/8 heads of 128, d_ff 22016,
     vocab 102400 untied; 67.4 GB, drawn leaf by leaf, each f32 draw
     quantized in place), once every earlier model is freed, on the churn
     cut to its first 8 requests and gens 8..16 (every forward dequantizes
     the 67.4 GB): plain with its warm-up, one profiled batch, the
     row-count check, self-drafted gamma 4 (the plain tokens) and composed
     (the fused tokens), each kernel's launches counted, peak memory and
     ``mem_get_info``; kernels 1, 2, 5 and 3 (gamma 4 and 8) at its 64/8
     heads of D 128, each bit for bit its exact plain version, timed by
     graph replay beside bound and SDPA (``"deepseek67b"`` in the JSON
     line); TinyLlama-1.1B at full width in bf16 and in int8 on the same
     cut churn (tok/s side by side); and the CIM datapath
     (``core/cim.py``) at one DeepSeek-67B MLP shape through kernel 8,
     its only caller: the nibble split (2 launches) and the bit-serial form
     (8 on one pre-pass) bit for bit kernel 8's direct product and its
     plain version's, the Q15 requant pipeline bit for bit the CPU's, each
     timed (``"cim"`` under kernel 8 in the JSON line).

 13. the distribution substrate (run after phase 7, before phase 8):
     ``launch.train.main`` at full TinyLlama-1.1B width, B 4 x 2048, 3
     steps, unbound and on a (1, 1) ``DeviceMesh`` over the card
     (``--mesh single --mesh-shape 1x1``: NCCL, world 1; parameters and
     moments DTensors placed by ``param_shardings``, the step under
     ``axis_rules``), losses, grad norms, parameters and moments bit for
     bit; the roofline terms of that step and of the churn's decode step
     (8 slots over a 290-position dense cache), counted by the dry-run on
     a (1, 1) fake mesh in a child process started after the build, beside
     the measured step and phase 6a's p50 (a step shorter than its compute
     term fails; the memory term's ratio is printed only: its byte count is
     unfused); and the dry-run CLI on OLMo-1B x train_4k on the
     (16, 16) fake mesh with ``launch.report`` on its output, in another
     child process (exit 0, one row). Lines ``[mesh]``, ``[roofline]``,
     ``[dryrun]``.

 15. the examples (``examples/*_torch.py``, run after phase 14, each
     ``main`` in this process so that the launch counters see it; lines
     ``[examples]``): quickstart on the card (kernel 1 once for the
     attention modes, once a layer for the prefill; kernel 4 once a layer
     a decode step) and on the CPU, the LUT lines equal, the greedy
     continuation equal (and the card's trained weights decoded on the
     CPU too), then ``python examples/quickstart_torch.py`` as a command,
     exit 0 and its last line the in-process run's; serve_batched (8
     served, 0 leaked, kernels 1 and 2 counted); train_lm's smoke default
     as a command, SIGTERMed once it logs step 20 (exit 143), then the
     same arguments again in this process, which resume and end bit for
     bit on a straight run (losses from the resumed step, parameters and
     moments), and ``--full --steps 3`` without a checkpoint (losses,
     step seconds, peak memory); accuracy_study at 20 steps card vs CPU,
     each row within ``ACCURACY_CHECK``'s tolerance, and at its default
     200 steps on the card (the float-to-int8 delta beside the paper's
     +-0.6%, a record); multi_pod_lower on ``EXAMPLE_CELL`` in a child
     process started after the build, its report equal to a direct
     ``dryrun_cell`` call's in another (host times aside), its roofline
     terms non-zero.  The examples' launches of kernels 1, 2 and 4 stand
     in the JSON line (``examples_launches``).

 16. the tile sweep (``kernels/autotune.py``, run after phase 15; lines
     ``[autotune]``): the CLI's sweeps of the dense decode at D 64 and
     D 80 and of the dense verify at gamma 4 and 8 at D 64, and the sweeps
     of the verify at gamma 4 and 8 at D 128, group 8, all over s_max 2048,
     each printing its table of every (block_k, g_pad_min) candidate's
     device time (or why the sweep refused it) and its winner, which the
     lookups then return; every timed instance bit for bit its exact plain
     version on the sweep's inputs; kernel 3's two row paddings timed and
     held the same way from a pool; then TinyLlama's dense churn at full
     width with its cache at 2048, unswept, with the swept decode winner
     in the cache, and unswept again: equal tokens, every dense decode
     launched through the swept tile's instance, or unswept through the
     default instance (the heuristic's answer launches it, as phase 15's
     examples check too).

Kernel 7 (dense verify) has no caller in any model, as in the reference:
its one caller is the tile sweep (phase 16), whose launches stand in the
JSON line; phases 3 and 4 check and time it too.  Kernels 3, 4, 6 and 7
carry their swept tiles' tables (``"tiles"``, ``"g_pad_min_us"``).
Kernel 8's launches are the CIM model's (``launches_by_path``); no
model's path launches it.  Kernels 1-3 also carry ``launches_by_path``.

The line before the last is the card's name and power limit; before it, one
JSON object with each kernel's numbers.  The last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or without the repository beside this script.

"""
from __future__ import annotations

import atexit
import gc
import itertools
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PREFILL = dict(b=1, hq=32, hkv=4, s=250, d=64)
DECODE = dict(b=8, hq=32, hkv=4, d=64, block_k=32, prompt=250, gen=32)
VERIFY = dict(b=8, hq=32, hkv=4, d=64, block_k=32, lens=(251, 282),
              gammas=(4, 8))
SERVE = dict(requests=24, slots=8, prompt_len=250, gen=32, block_k=32, seed=0)
# the dense churn's cache: prompt + max gen + 8 (serve_dense's default)
DENSE = dict(b=8, hq=32, hkv=4, d=64, s_max=290, lens=(251, 282),
             gammas=(4, 8))
REPREFILL = dict(b=8, hq=32, hkv=4, s=282, d=64)
# the fakequant->int8 check's int8 forward at full width: TinyLlama's 2048
# pretraining context, one sequence
INT8_CHECK = dict(b=1, hq=32, hkv=4, s=2048, d=64)
# DeepSeekMoE-16B's attention (MHA, group 1, at D 128) at the churn's
# shapes: a 250-token admission, 8 slots over the pool, gamma 4 verify
MOE_HEADS = dict(hq=16, hkv=16, d=128)
MOE_PREFILL = dict(b=1, s=250, **MOE_HEADS)
# the dense family's GQA groups at D 128, at the same three shapes:
# Mistral-NeMo-12B (group 4) and DeepSeek-Coder-33B (group 7, the first odd
# group); Chameleon-34B and DeepSeek-67B are group 8 at D 128, the verify's
# FULL_GROUP shape below
DENSE_HEADS = {"mistral_nemo": dict(hq=32, hkv=8, d=128),
               "deepseek_coder": dict(hq=56, hkv=8, d=128)}
# (m, k, n); the last is the timed TinyLlama width
GEMMS = [(256, 512, 256), (128, 128, 128), (512, 256, 384), (300, 1000, 130),
         (1, 16, 5), (129, 272, 264), (2048, 2048, 5632)]
# operand copies the L2-cold GEMM timings rotate through: 8 x 15.5 MB of x
# and w at the timed width, past the H100's 50 MB L2
COLD_COPIES = 8
SPEC = dict(gamma=4, prefix_layers=4)
# verify shapes past the first verify kernel's cap of group x T x D <= 4096
# (group 8): (T, D)
FULL_GROUP = ((16, 64), (8, 128))
COMPOSED_REQUESTS = 8
# the reference bench's pressure cell: a pool for 5 full sequences
PRESSURE_POOL_SEQS = 5
CHAOS = dict(exhaust_step=6, exhaust_hold=5, delay_step=14, delay_seconds=0.3,
             nan_step=20, nan_slot=1)
CHAOS_DEADLINE_STEPS = 300
SAMPLED = dict(temperature=0.8, top_p=0.95, sample_seed=3)
# QAT training: the smoke checks (card vs CPU, determinism, CLI resume), the
# reference system test's fakequant->int8 setting (tests/test_system.py), and
# the full-width run at TinyLlama's pretraining context (arXiv:2401.02385)
TRAIN_SMOKE = dict(batch=8, seq=64, seed=0, steps=5)
FQ_INT8 = dict(steps=30, batch=8, seq=48, seed=11, tokens=32)
TRAIN_FULL = dict(batch=4, seq=2048, steps=8, warmup=2, seed=0)
# phase 14, training the other families: each smoke config card vs CPU,
# the step twice, the CLI's resume, and (where it has attention) the
# fakequant->int8 agreement through kernel 1 as a record; then each at full
# width through ``launch.train.main``, 3 steps of B 4 x 2048 (each fits the
# card), depth cut where the state (f32 masters, gradients, two moments: 16
# B a parameter) does not fit:
# (arch, layers or None for all); Falcon-Mamba's batch and
# depth (from 4 layers up) are planned from one layer's measured step peak
FAMILY_SMOKE_ARCHS = ("deepseek_moe_16b", "mixtral_8x22b", "falcon_mamba_7b",
                      "zamba2_2p7b", "seamless_m4t_medium")
FAMILY_FULL = (("zamba2_2p7b", None), ("seamless_m4t_medium", None),
               ("deepseek_moe_16b", 4), ("falcon_mamba_7b", 4))
FAMILY_TRAIN = dict(batch=4, seq=2048, steps=3, warmup=2, seed=0)
# card vs CPU over the smoke steps: with float attention every loss and grad
# norm within 1e-5; as trained (fakequant) the losses and the grad norms
# within 1e-3, a grad norm past it only where the CPU run itself, from its
# inputs moved by +-1 ulp (FAMILY_ULP_DRAWS draws, numpy seed 0), moves it
# at least as far (each such step printed with the farthest draw and the
# nearest; the nearest lies past 1e-3 of DeepSeekMoE's step 5): a last-bit
# difference of an upstream f32 sum (the norms' means) moves a score on a
# .5 edge of the int8 grid to the next index, and the straight-through
# gradient carries the jump (measured up to 3.1e-3 on Mixtral's smoke grad
# norms, float attention 6.4e-7); the first such edge of each config is
# printed.  The first step's gradient leaves stay within 1e-2 of their
# scale: SeamlessM4T's pass 1e-3 (up to 2.3e-3) by more than the CPU's own
# one-ulp spread moves them, the card's first forward crossing more edges
# than a one-ulp nudge of the CPU's inputs does
FAMILY_CARD_TOL = dict(float=1e-5, loss=1e-3, grad_norm=1e-3, grad_leaf=1e-2)
FAMILY_ULP_DRAWS = 8
# the MoE family: DeepSeekMoE-16B at full width (the one MoE config of the
# reference's registry that one card holds), both MoE smoke configs
MOE_ARCH = "deepseek_moe_16b"
MOE_SMOKE_ARCHS = ("deepseek_moe_16b", "mixtral_8x22b")
# router probabilities this close at the k-th/(k+1)-th rank may swap
MOE_TIE = 1e-6
# the MoE layer check's bf16 tolerances (see moe_layer_check)
MOE_TOL_MAX = 2 ** -5
MOE_TOL_RMS = 2 ** -7
# the rest of the dense family: every smoke config card vs CPU, and two at
# full width (Mistral-NeMo-12B, 24.5 GB in bf16; OLMo-1B, the tied head);
# Chameleon-34B and DeepSeek-Coder-33B (67 GB in bf16) run at smoke size
# only, and DeepSeek-67B (135 GB in bf16) serves in int8 (phase 12)
DENSE_SMOKE_ARCHS = ("olmo_1b", "mistral_nemo_12b", "chameleon_34b",
                     "deepseek_coder_33b", "deepseek_67b")
NEMO_ARCH = "mistral_nemo_12b"
OLMO_ARCH = "olmo_1b"
# the encoder-decoder family: SeamlessM4T-medium at full width (16/16 heads
# of 64), its encoder frames drawn as the serving CLI draws them; kernel 1
# at its three attentions (encoder bidirectional, decoder self causal,
# cross non-causal over the encoder's keys, also over a 1024-frame stream
# longer than the prompt), kernels 2 and 5 over the 8-slot carved bank
SEAMLESS_ARCH = "seamless_m4t_medium"
SEAMLESS_HEADS = dict(hq=16, hkv=16, d=64)
SEAMLESS_PREFILL = (("encoder", 250, 250, False), ("self", 250, 250, True),
                    ("cross", 250, 250, False), ("cross 1024", 250, 1024,
                                                 False))
# the SSM and hybrid families at full width: Falcon-Mamba-7B (Mamba-1,
# served through the int8 state-slab engine and the dense cache, forced
# preemption at step 10 of slot 3) and Zamba2-2.7B (Mamba-2 with one shared
# attention block of 32/32 heads of 80, served through the dense cache)
SSM_ARCH = "falcon_mamba_7b"
HYBRID_ARCH = "zamba2_2p7b"
HYBRID_HEADS = dict(hq=32, hkv=32, d=80)
FORCED_PREEMPT = dict(preempt_step=10, preempt_slot=3)
# int8 serve weights: the smoke configs served card vs CPU (one of each
# family that serves in int8: the dense, MoE, encoder-decoder and hybrid),
# DeepSeek-67B at full width (67.4 GB in int8; 64/8 heads of 128, GQA group
# 8) on a cut churn (16 requests on the 8 slots, so that half of them are
# admitted while others decode), the CIM datapath at one of its MLP shapes
# (x @ w_in)
INT8_SMOKE_ARCHS = ("tinyllama_1p1b", "deepseek_moe_16b",
                    "seamless_m4t_medium", "zamba2_2p7b")
DS_ARCH = "deepseek_67b"
DS_HEADS = dict(hq=64, hkv=8, d=128)
DS_CHURN = dict(requests=16, gen=16)
# TinyLlama with bf16 and int8 serve weights on the serving churn, runs
# interleaved
INT8_VS_BF16_ORDER = ("bfloat16", "int8", "int8", "bfloat16", "bfloat16",
                      "int8")
CIM_SHAPE = (256, 8192, 22016)
CIM_REQUANT_MULTIPLIERS = (1e-5, 0.001, 0.0117, 0.3)
# the distribution substrate on the card: TinyLlama's full-width train step
# on a (1, 1) mesh against the unbound step; the roofline terms of that step
# and of the churn's decode step (8 slots over the dense cache's 290
# positions), counted by the dry-run on a (1, 1) fake mesh in a child
# process; and the dry-run CLI on one grid cell with its report
MESH_TRAIN = dict(batch=4, seq=2048, steps=3, warmup=2, seed=0)
CARD_CELLS = (("card train", "train", 2048, 4),
              ("card decode", "decode", 290, 8))
DRYRUN_CELL = ("olmo_1b", "train_4k")
# the examples phase (examples/*_torch.py): the multi-pod dry-run cell of
# multi_pod_lower_torch.py; train_lm_torch.py's smoke default is stopped by
# SIGTERM once it logs this step (its checkpoint step); accuracy_study's
# short run, card vs CPU, and each row's tolerance there: relative for the
# train loss, absolute for the errors and the TV, in positions for the
# three counts (their positions: 4 eval batches x 8 rows x 63 or 64).
# On the CPU, weights 1e-7 apart relatively move the 20-step loss by up to
# 1.2e-4 of itself, the TV by 9e-5 and each count by up to 4 positions
EXAMPLE_CELL = ("olmo_1b", "decode_32k")
EXAMPLE_SIGTERM_STEP = 20
ACCURACY_CHECK = dict(steps=20, prob_err=1e-6, train_loss=1e-3, tv=1e-3,
                      positions=16)
ACCURACY_POSITIONS = {"accuracy.task_float": 4 * 8 * 63,
                      "accuracy.task_int8_lut": 4 * 8 * 63,
                      "accuracy.top1_agreement": 4 * 8 * 64}
# quickstart_torch.py's card and CPU runs: drift lines within this, losses
# within QUICKSTART_LOSS_RTOL of each other (a gross-fault bound: weights
# 1e-7 apart move its step-15 loss by 3e-4 of itself on the CPU)
QUICKSTART_DRIFT_TOL = 1e-3
QUICKSTART_LOSS_RTOL = 1e-2
# the float/fakequant decode baselines, card vs CPU: max |logit diff| over
# the logits' scale (tests/test_torch_decode_baselines.py states the same)
DECODE_BASELINE_TOL = 2e-3
# the reference's bound on the reciprocal LUT's error against the division
# (tests/test_fused_decode.py::test_fused_recip_lut_error_bounded)
RECIP_LUT_REL_ERR = 2 ** -8


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


# Closures timed by graph replay after the kernel phases, by key: kernels,
# their SDPA / torch._int_mm yardsticks, and the launch floor.
GRAPHED = {}
# Each split-softmax kernel's main inputs, by kernel name: (args, kwargs,
# tolerance), for the options phase.
MAIN_ARGS = {}
GRAPH_ITERS = 50
GRAPH_ROUNDS = 7


def time_ms(torch, fn, iters: int = 50, warm: int = 5) -> float:
    """Host-inclusive time of ``fn``: CUDA events around ``iters``
    back-to-back Python calls (inputs stay L2-resident across calls).  For a
    kernel of a few microseconds this measures the wrapper's host cost, not
    the device: see :func:`graph_rounds`."""
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


def graph_rounds(torch, fns, iters: int = GRAPH_ITERS,
                 rounds: int = GRAPH_ROUNDS):
    """Device time per call of each closure in ``fns`` (name -> fn): its
    ``iters`` calls captured once in a CUDA graph, the replay timed with
    CUDA events, ``rounds`` rounds interleaved across all the closures.
    Returns name -> (median, min, max) in ms per call."""
    import statistics
    graphs = {}
    for name, fn in fns.items():
        fn()                         # load, set attributes, warm caches
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        graphs[name] = g
    torch.cuda.synchronize()
    times = {name: [] for name in graphs}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(rounds):
        for name, g in graphs.items():
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    return {name: (statistics.median(t), min(t), max(t))
            for name, t in times.items()}


def rotating(fn, args):
    """``fn`` on each tuple of ``args`` in turn, one a call: captured in a
    CUDA graph, successive calls read different operands."""
    turn = itertools.count()
    return lambda: fn(*args[next(turn) % len(args)])


def bound_ms(n_bytes: int, n_ops: int):
    """The larger of the bytes over HBM3's rate and the int8 operations
    over the int8 tensor-core peak (``launch/roofline.py``: the H100 SXM
    data sheet's constants)."""
    from repro_torch.launch.roofline import HBM_BW, PEAK_OPS_INT8
    t_bytes = n_bytes / HBM_BW * 1e3
    t_ops = n_ops / PEAK_OPS_INT8 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tolerance(s_v: float) -> float:
    """The default plain version rounds its f32 sums of e*v and the kernels
    sum them exactly (each equals the plain version's ``exact=True`` bit for
    bit): bound the difference at 2e-5 of the output's full scale 127 * s_v
    (~n * 2^-24 for n <= 300)."""
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
    (b, T)`` is each query's visible length.  Returns the call, for
    :func:`graph_rounds`."""
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
    return lambda: F.scaled_dot_product_attention(qb, kd, vd, attn_mask=mask)


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
        exact = K.splitmax_attention_plain(*args, exact=True, **kw)
        torch.cuda.synchronize()
        err = float((ker - plain).abs().max()) if ker.numel() else 0.0
        tol = tolerance(float(s_v))
        check(bool(torch.isfinite(ker).all()), f"prefill {sq}x{sk}: non-finite")
        check(torch.equal(ker, exact), f"prefill b{b} hq{hq} hkv{hkv} {sq}x{sk} "
              f"d{d} causal={causal} window={window} kv_valid={kv_valid}: "
              f"kernel != the exact=True plain version")
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
        # MHA at D 128 (the kKSteps 4 instance): DeepSeekMoE's admission,
        # and a ragged tail
        dict(b=1, hq=16, hkv=16, sq=250, sk=250, d=128),
        dict(b=1, hq=16, hkv=16, sq=33, sk=33, d=128),
    ]
    for e in edges:
        _, _, err, tol, _ = case(**e)
        print(f"[prefill] edge {e}: == exact oracle, max_abs_err {err:.3g} "
              f"(tol {tol:.3g})")

    def prefill_bound(b, hq, hkv, s, d):
        pairs = b * hq * s * (s + 1) // 2                # causal live (q, k)
        n_bytes = (b * hq * s * d                        # int8 q
                   + 2 * b * hkv * s * d                 # int8 k, v
                   + 4 * b * hq * s * d                  # f32 out
                   + 4 * (256 + cfg.recip_table_size))   # LUTs
        # 2D for q.k; 4D for e.V with e (<= 2^15) split into two int8 halves
        return bound_ms(n_bytes, pairs * 6 * d)

    def sdpa_fn(q, k, v):
        g = q.shape[1] // k.shape[1]
        kb, vb = (x.to(torch.bfloat16).repeat_interleave(g, dim=1)
                  for x in (k, v))
        qb = q.to(torch.bfloat16)
        return lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                      is_causal=True)

    p = PREFILL
    args, kw, err, tol, (q, k, v) = case(p["b"], p["hq"], p["hkv"], p["s"],
                                         p["s"], p["d"])
    MAIN_ARGS["splitmax_attention"] = (args, kw, tol)
    GRAPHED["prefill"] = lambda: K.splitmax_attention_cuda(*args, **kw)
    GRAPHED["prefill sdpa"] = sdpa_fn(q, k, v)
    ms = time_ms(torch, GRAPHED["prefill"])
    plain_ms = time_ms(torch, lambda: K.splitmax_attention_plain(*args, **kw),
                       iters=10)
    bms, by = prefill_bound(p["b"], p["hq"], p["hkv"], p["s"], p["d"])
    print(f"[prefill] main {p}: == exact oracle, max_abs_err {err:.3g} (tol "
          f"{tol:.3g}), kernel host-inclusive {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")

    # the dense path's re-prefill: every slot at once, one per-tensor scale
    r = REPREFILL
    rargs, rkw, rerr, rtol, (rq, rk, rv) = case(r["b"], r["hq"], r["hkv"],
                                                r["s"], r["s"], r["d"])
    GRAPHED["re-prefill"] = lambda: K.splitmax_attention_cuda(*rargs, **rkw)
    GRAPHED["re-prefill sdpa"] = sdpa_fn(rq, rk, rv)
    r_ms = time_ms(torch, GRAPHED["re-prefill"])
    r_plain_ms = time_ms(torch, lambda: K.splitmax_attention_plain(
        *rargs, **rkw), iters=10)
    r_bms, r_by = prefill_bound(r["b"], r["hq"], r["hkv"], r["s"], r["d"])
    print(f"[prefill] re-prefill {r}: == exact oracle, max_abs_err "
          f"{rerr:.3g} (tol {rtol:.3g}), kernel host-inclusive {r_ms:.4f} ms, "
          f"plain {r_plain_ms:.4f} ms, bound {r_bms:.5f} ms ({r_by})")
    # the fakequant->int8 check's teacher-forced int8 forward at S 2048
    c = INT8_CHECK
    cargs, ckw, cerr, ctol, (cq, ck, cv) = case(c["b"], c["hq"], c["hkv"],
                                                c["s"], c["s"], c["d"])
    GRAPHED["prefill 2048"] = lambda: K.splitmax_attention_cuda(*cargs, **ckw)
    GRAPHED["prefill 2048 sdpa"] = sdpa_fn(cq, ck, cv)
    c_ms = time_ms(torch, GRAPHED["prefill 2048"])
    c_plain_ms = time_ms(torch, lambda: K.splitmax_attention_plain(
        *cargs, **ckw), iters=3, warm=1)
    c_bms, c_by = prefill_bound(c["b"], c["hq"], c["hkv"], c["s"], c["d"])
    print(f"[prefill] int8 check {c}: == exact oracle, max_abs_err "
          f"{cerr:.3g} (tol {ctol:.3g}), kernel host-inclusive {c_ms:.4f} ms, "
          f"plain {c_plain_ms:.4f} ms, bound {c_bms:.5f} ms ({c_by})")
    # DeepSeekMoE-16B's admission: MHA at D 128
    m = MOE_PREFILL
    margs, mkw, merr, mtol, (mq, mk, mv) = case(m["b"], m["hq"], m["hkv"],
                                                m["s"], m["s"], m["d"])
    GRAPHED["prefill moe"] = lambda: K.splitmax_attention_cuda(*margs, **mkw)
    GRAPHED["prefill moe sdpa"] = sdpa_fn(mq, mk, mv)
    m_ms = time_ms(torch, GRAPHED["prefill moe"])
    m_plain_ms = time_ms(torch, lambda: K.splitmax_attention_plain(
        *margs, **mkw), iters=10)
    m_bms, m_by = prefill_bound(m["b"], m["hq"], m["hkv"], m["s"], m["d"])
    print(f"[prefill] moe {m}: == exact oracle, max_abs_err {merr:.3g} (tol "
          f"{mtol:.3g}), kernel host-inclusive {m_ms:.4f} ms, plain "
          f"{m_plain_ms:.4f} ms, bound {m_bms:.5f} ms ({m_by})")
    # the dense family's admissions: GQA groups 4 and 7 at D 128
    dense = {}
    for key, heads in DENSE_HEADS.items():
        h = dict(b=1, s=250, **heads)
        for e in (dict(sq=33, sk=33), dict(sq=100, sk=100, window=16)):
            _, _, e_err, e_tol, _ = case(1, heads["hq"], heads["hkv"],
                                         d=heads["d"], **e)
            print(f"[prefill] {key} edge {e}: == exact oracle, max_abs_err "
                  f"{e_err:.3g} (tol {e_tol:.3g})")
        hargs, hkw, herr, htol, (hq_, hk_, hv_) = case(
            1, heads["hq"], heads["hkv"], 250, 250, heads["d"])
        GRAPHED[f"prefill {key}"] = (
            lambda a=hargs, k=hkw: K.splitmax_attention_cuda(*a, **k))
        GRAPHED[f"prefill {key} sdpa"] = sdpa_fn(hq_, hk_, hv_)
        h_ms = time_ms(torch, GRAPHED[f"prefill {key}"])
        h_plain_ms = time_ms(torch, lambda: K.splitmax_attention_plain(
            *hargs, **hkw), iters=10)
        h_bms, h_by = prefill_bound(1, heads["hq"], heads["hkv"], 250,
                                    heads["d"])
        print(f"[prefill] {key} {h}: == exact oracle, max_abs_err {herr:.3g} "
              f"(tol {htol:.3g}), kernel host-inclusive {h_ms:.4f} ms, plain "
              f"{h_plain_ms:.4f} ms, bound {h_bms:.5f} ms ({h_by})")
        merr = max(merr, herr)
        dense[key] = {"shape": h, "graph": f"prefill {key}",
                      "library_graph": f"prefill {key} sdpa", "host_ms": h_ms,
                      "plain_ms": h_plain_ms, "bound_ms": h_bms,
                      "bound_by": h_by}
    return {"name": "splitmax_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/splitmax_attn.cu",
            "replaces": "src/repro/kernels/splitmax_attn.py:181",
            "path": "paged admissions and resumes (the encoder-decoder's "
                    "encoder, self and cross attentions too), dense "
                    "re-prefills, the "
                    "fakequant->int8 check's int8 forward, MoE and dense-"
                    "family admissions",
            "max_abs_err": max(err, rerr, cerr, merr), "exact_equal": True,
            "graph": "prefill", "library_graph": "prefill sdpa",
            "host_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by,
            "reprefill": {"shape": r, "graph": "re-prefill",
                          "library_graph": "re-prefill sdpa",
                          "host_ms": r_ms, "plain_ms": r_plain_ms,
                          "bound_ms": r_bms, "bound_by": r_by},
            "int8_check": {"shape": c, "graph": "prefill 2048",
                           "library_graph": "prefill 2048 sdpa",
                           "host_ms": c_ms, "plain_ms": c_plain_ms,
                           "bound_ms": c_bms, "bound_by": c_by},
            "moe": {"shape": m, "graph": "prefill moe",
                    "library_graph": "prefill moe sdpa", "host_ms": m_ms,
                    "plain_ms": m_plain_ms, "bound_ms": m_bms,
                    "bound_by": m_by}, **dense}


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
        exact = K.splitmax_decode_fused_paged_plain(*args, cfg=cfg,
                                                    window=window, exact=True)
        check(torch.equal(ker, exact), f"decode {what}: kernel != the "
              f"exact=True plain version")
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
    print(f"[decode] edges lens {edge_lens} (slot 6 idle): == exact oracle, "
          f"max_abs_err {err:.3g} (tol {tol:.3g})")
    err, tol = compare(make([40, 77, 96], 8, 2, 16, 8), "smoke shape d16",
                       window=None)
    print(f"[decode] smoke shape: == exact oracle, max_abs_err {err:.3g} "
          f"(tol {tol:.3g})")
    err, tol = compare(make([100, 64, 33], hq, hkv, d, bk), "window 48",
                       window=48)
    print(f"[decode] window 48: == exact oracle, max_abs_err {err:.3g} (tol "
          f"{tol:.3g})")
    mh = (MOE_HEADS["hq"], MOE_HEADS["hkv"], MOE_HEADS["d"])
    err, tol = compare(make(edge_lens, *mh, bk, idle=(6,)),
                       "moe heads edges (group 1, d 128)")
    print(f"[decode] group 1, d 128, lens {edge_lens} (slot 6 idle): == "
          f"exact oracle, max_abs_err {err:.3g} (tol {tol:.3g})")

    lens = torch.randint(p["prompt"] + 1, p["prompt"] + p["gen"] + 1,
                         (p["b"],), generator=gen, device=dev).tolist()
    args = make(lens, hq, hkv, d, bk)
    err, tol = compare(args, f"main lens {lens}")
    args[1][paged_kv.TRASH_BLOCK] = 127
    args[2][paged_kv.TRASH_BLOCK] = 127
    MAIN_ARGS["splitmax_decode_fused_paged"] = (args, dict(cfg=cfg), tol)
    GRAPHED["decode"] = lambda: K.splitmax_decode_fused_paged_cuda(*args,
                                                                    cfg=cfg)
    ms = time_ms(torch, GRAPHED["decode"])
    plain_ms = time_ms(torch, lambda: K.splitmax_decode_fused_paged_plain(
        *args, cfg=cfg), iters=10)
    b = p["b"]
    GRAPHED["decode sdpa"] = sdpa_decode_yardstick(torch, F, gen, dev, b, hq,
                                                   d, [[n] for n in lens])

    def decode_bound(lens, hq, hkv, d):
        total = sum(lens)
        tiles = sum(paged_kv.blocks_per_seq(n, bk) for n in lens)
        n_bytes = (4 * b * hq * d                # f32 q
                   + 2 * hkv * d * total         # int8 k, v at live positions
                   + 4 * tiles + 4 * b * 3       # table entries, lens, scales
                   + 4 * b * hq * d              # f32 out
                   + 4 * (256 + cfg.recip_table_size))
        return bound_ms(n_bytes, total * hq * 6 * d)

    bms, by = decode_bound(lens, hq, hkv, d)
    print(f"[decode] main lens {lens}: == exact oracle, max_abs_err "
          f"{err:.3g} (tol {tol:.3g}), kernel host-inclusive {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")
    # DeepSeekMoE-16B's decode: 8 slots, group 1 at D 128
    m_lens = torch.randint(p["prompt"] + 1, p["prompt"] + p["gen"] + 1,
                           (b,), generator=gen, device=dev).tolist()
    m_args = make(m_lens, *mh, bk)
    m_err, _ = compare(m_args, f"moe main lens {m_lens}")
    m_args[1][paged_kv.TRASH_BLOCK] = 127
    m_args[2][paged_kv.TRASH_BLOCK] = 127
    GRAPHED["decode moe"] = lambda: K.splitmax_decode_fused_paged_cuda(
        *m_args, cfg=cfg)
    GRAPHED["decode moe sdpa"] = sdpa_decode_yardstick(
        torch, F, gen, dev, b, mh[0], mh[2], [[n] for n in m_lens])
    m_ms = time_ms(torch, GRAPHED["decode moe"])
    m_plain_ms = time_ms(torch, lambda: K.splitmax_decode_fused_paged_plain(
        *m_args, cfg=cfg), iters=10)
    m_bms, m_by = decode_bound(m_lens, *mh)
    print(f"[decode] moe main lens {m_lens} heads {mh}: == exact oracle, "
          f"max_abs_err {m_err:.3g}, kernel host-inclusive {m_ms:.4f} ms, "
          f"plain {m_plain_ms:.4f} ms, bound {m_bms:.5f} ms ({m_by})")
    # the dense family's decode: 8 slots, GQA groups 4 and 7 at D 128
    dense = {}
    for key, heads in DENSE_HEADS.items():
        hh = (heads["hq"], heads["hkv"], heads["d"])
        e_err, _ = compare(make(edge_lens, *hh, bk, idle=(6,)),
                           f"{key} heads edges")
        w_err, _ = compare(make([100, 64, 33], *hh, bk), f"{key} window 48",
                           window=48)
        h_lens = torch.randint(p["prompt"] + 1, p["prompt"] + p["gen"] + 1,
                               (b,), generator=gen, device=dev).tolist()
        h_args = make(h_lens, *hh, bk)
        h_err, _ = compare(h_args, f"{key} main lens {h_lens}")
        h_args[1][paged_kv.TRASH_BLOCK] = 127
        h_args[2][paged_kv.TRASH_BLOCK] = 127
        GRAPHED[f"decode {key}"] = (
            lambda a=h_args: K.splitmax_decode_fused_paged_cuda(*a, cfg=cfg))
        GRAPHED[f"decode {key} sdpa"] = sdpa_decode_yardstick(
            torch, F, gen, dev, b, hh[0], hh[2], [[n] for n in h_lens])
        h_ms = time_ms(torch, GRAPHED[f"decode {key}"])
        h_plain_ms = time_ms(
            torch, lambda: K.splitmax_decode_fused_paged_plain(*h_args,
                                                               cfg=cfg),
            iters=10)
        h_bms, h_by = decode_bound(h_lens, *hh)
        print(f"[decode] {key} heads {hh}, edges (slot 6 idle), window 48 "
              f"and main lens {h_lens}: == exact oracle, max_abs_err "
              f"{max(e_err, w_err, h_err):.3g}, kernel host-inclusive "
              f"{h_ms:.4f} ms, plain {h_plain_ms:.4f} ms, bound {h_bms:.5f} "
              f"ms ({h_by})")
        m_err = max(m_err, e_err, w_err, h_err)
        dense[key] = {"shape": dict(b=b, lens=h_lens, **heads),
                      "graph": f"decode {key}",
                      "library_graph": f"decode {key} sdpa",
                      "host_ms": h_ms, "plain_ms": h_plain_ms,
                      "bound_ms": h_bms, "bound_by": h_by}
    return {"name": "splitmax_decode_fused_paged", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/splitmax_decode.cu",
            "replaces": "src/repro/kernels/splitmax_decode.py:747",
            "path": "paged decode steps (self and, encoder-decoder, cross "
                    "over the carved bank), draft steps",
            "max_abs_err": max(err, m_err), "exact_equal": True,
            "graph": "decode", "library_graph": "decode sdpa", "host_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "moe": {"shape": dict(b=b, lens=m_lens, **MOE_HEADS),
                    "graph": "decode moe", "library_graph": "decode moe sdpa",
                    "host_ms": m_ms, "plain_ms": m_plain_ms,
                    "bound_ms": m_bms, "bound_by": m_by}, **dense}, args


# ----------------------------------------------------------------- verify --

def verify_phase(torch, F, dev):
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

    def case(lens, gamma, what, *, window=None, idle=(), heads=(hq, hkv, d)):
        hq, hkv, d = heads
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
        exact = K.splitmax_decode_fused_verify_paged_plain(
            *args, cfg=cfg, window=window, exact=True)
        check(torch.equal(ker, exact), f"verify {what}: kernel != the "
              f"exact=True plain version")
        # each row is the decode kernel at its effective length, bit for bit
        rows = [[q[:, :, t].contiguous(), kp, vp, table,
                 m_z[:, t].contiguous(), s_q[:, t].contiguous(), args[6],
                 torch.clamp_min(lens_t - (gamma - 1 - t), 0), exp_lut,
                 recip_lut] for t in range(gamma)]
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
        print(f"[verify] {what}: lens {lens}, gamma {gamma}, heads {heads}, "
              f"window {window}: == exact oracle, max_abs_err {err:.3g} (tol "
              f"{tol:.3g}), rows == decode kernel")
        return args, rows, err, tol

    for gamma in p["gammas"]:
        # token 0 sees one position; slot 2's tokens straddle the 2*bk
        # boundary; slot 4 idle; a window cutting into the tiles
        edges = [gamma, bk, 2 * bk + gamma // 2, 250, gamma, 282, 96, 33]
        case(edges, gamma, "edges", idle=(4,))
        case(edges, gamma, "edges window 48", window=48, idle=(4,))
    case([40, 77, 96], 4, "smoke-width heads d 64")

    def verify_bound(lens, gamma, hq, hkv, d):
        b = len(lens)
        q_lens = [[n - (gamma - 1 - t) for t in range(gamma)] for n in lens]
        tiles = sum(paged_kv.blocks_per_seq(n, bk) for n in lens)
        pairs = hq * sum(sum(row) for row in q_lens)    # live (query, key)
        n_bytes = (4 * b * hq * gamma * d           # f32 q
                   + 2 * hkv * d * sum(lens)        # int8 k, v, read once
                   + 4 * tiles + 4 * b              # table entries, lens
                   + 2 * 4 * b * gamma + 4          # m_z, s_q, s_v
                   + 4 * b * hq * gamma * d         # f32 out
                   + 4 * (256 + cfg.recip_table_size))
        return bound_ms(n_bytes, pairs * 6 * d)

    results = []
    for gamma in p["gammas"]:
        lens = torch.randint(p["lens"][0], p["lens"][1] + 1, (p["b"],),
                             generator=gen, device=dev).tolist()
        args, rows, err, tol = case(lens, gamma, "main")
        args[1][paged_kv.TRASH_BLOCK] = 127
        args[2][paged_kv.TRASH_BLOCK] = 127
        if gamma == SPEC["gamma"]:
            MAIN_ARGS["splitmax_decode_fused_verify_paged"] = (
                args, dict(cfg=cfg), tol)
        key = f"verify g{gamma}"
        GRAPHED[key] = (lambda a=args: K.splitmax_decode_fused_verify_paged_cuda(
            *a, cfg=cfg))
        ms = time_ms(torch, GRAPHED[key])
        plain_ms = time_ms(torch, lambda: K.splitmax_decode_fused_verify_paged_plain(
            *args, cfg=cfg), iters=10)

        def decodes(rows=rows):
            for row in rows:
                K.splitmax_decode_fused_paged_cuda(*row, cfg=cfg)

        GRAPHED[f"{key} decodes"] = decodes
        b = p["b"]
        q_lens = [[n - (gamma - 1 - t) for t in range(gamma)] for n in lens]
        GRAPHED[f"{key} sdpa"] = sdpa_decode_yardstick(torch, F, gen, dev, b,
                                                       hq, d, q_lens)
        bms, by = verify_bound(lens, gamma, hq, hkv, d)
        print(f"[verify] main gamma {gamma}: kernel host-inclusive {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")
        results.append({
            "name": "splitmax_decode_fused_verify_paged", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/splitmax_verify.cu",
            "replaces": "src/repro/kernels/splitmax_decode.py:820",
            "path": "paged speculative verify", "gamma": gamma,
            "max_abs_err": err, "exact_equal": True, "graph": key,
            "library_graph": f"{key} sdpa", "decodes_graph": f"{key} decodes",
            "host_ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by})
    for gamma, wide in FULL_GROUP:
        # group 8 x T x D past the first kernel's thread cap
        edges = [gamma, bk, 2 * bk + gamma // 2, 250, gamma, 282, 96, 33]
        for window in (None, 48):
            case(edges, gamma, f"full group d {wide}", window=window,
                 idle=(4,), heads=(hq, hkv, wide))
        lens = torch.randint(p["lens"][0], p["lens"][1] + 1, (p["b"],),
                             generator=gen, device=dev).tolist()
        args = case(lens, gamma, f"full group d {wide} main",
                    heads=(hq, hkv, wide))[0]
        GRAPHED[f"verify g{gamma} d{wide}"] = (
            lambda a=args: K.splitmax_decode_fused_verify_paged_cuda(*a,
                                                                     cfg=cfg))
    # DeepSeekMoE-16B's verify: group 1 at D 128, the serving gamma
    mh = (MOE_HEADS["hq"], MOE_HEADS["hkv"], MOE_HEADS["d"])
    gamma = SPEC["gamma"]
    edges = [gamma, bk, 2 * bk + gamma // 2, 250, gamma, 282, 96, 33]
    for window in (None, 48):
        case(edges, gamma, "moe heads (group 1, d 128)", window=window,
             idle=(4,), heads=mh)
    m_lens = torch.randint(p["lens"][0], p["lens"][1] + 1, (p["b"],),
                           generator=gen, device=dev).tolist()
    m_args, m_rows, m_err, _ = case(m_lens, gamma, "moe main", heads=mh)
    m_args[1][paged_kv.TRASH_BLOCK] = 127
    m_args[2][paged_kv.TRASH_BLOCK] = 127
    GRAPHED["verify moe"] = lambda: K.splitmax_decode_fused_verify_paged_cuda(
        *m_args, cfg=cfg)
    GRAPHED["verify moe sdpa"] = sdpa_decode_yardstick(
        torch, F, gen, dev, p["b"], mh[0], mh[2],
        [[n - (gamma - 1 - t) for t in range(gamma)] for n in m_lens])
    m_ms = time_ms(torch, GRAPHED["verify moe"])
    m_plain_ms = time_ms(
        torch, lambda: K.splitmax_decode_fused_verify_paged_plain(
            *m_args, cfg=cfg), iters=10)
    m_bms, m_by = verify_bound(m_lens, gamma, *mh)
    print(f"[verify] moe main gamma {gamma} heads {mh}: kernel "
          f"host-inclusive {m_ms:.4f} ms, plain {m_plain_ms:.4f} ms, bound "
          f"{m_bms:.5f} ms ({m_by})")
    # the dense family's verify: GQA groups 4 and 7 at D 128, gamma 4
    dense = {}
    for key, heads in DENSE_HEADS.items():
        hh = (heads["hq"], heads["hkv"], heads["d"])
        for window in (None, 48):
            case(edges, gamma, f"{key} heads", window=window, idle=(4,),
                 heads=hh)
        h_lens = torch.randint(p["lens"][0], p["lens"][1] + 1, (p["b"],),
                               generator=gen, device=dev).tolist()
        h_args, _, h_err, _ = case(h_lens, gamma, f"{key} main", heads=hh)
        h_args[1][paged_kv.TRASH_BLOCK] = 127
        h_args[2][paged_kv.TRASH_BLOCK] = 127
        GRAPHED[f"verify {key}"] = (
            lambda a=h_args: K.splitmax_decode_fused_verify_paged_cuda(
                *a, cfg=cfg))
        GRAPHED[f"verify {key} sdpa"] = sdpa_decode_yardstick(
            torch, F, gen, dev, p["b"], hh[0], hh[2],
            [[n - (gamma - 1 - t) for t in range(gamma)] for n in h_lens])
        h_ms = time_ms(torch, GRAPHED[f"verify {key}"])
        h_plain_ms = time_ms(
            torch, lambda: K.splitmax_decode_fused_verify_paged_plain(
                *h_args, cfg=cfg), iters=10)
        h_bms, h_by = verify_bound(h_lens, gamma, *hh)
        print(f"[verify] {key} main gamma {gamma} heads {hh}: kernel "
              f"host-inclusive {h_ms:.4f} ms, plain {h_plain_ms:.4f} ms, "
              f"bound {h_bms:.5f} ms ({h_by})")
        m_err = max(m_err, h_err)
        dense[key] = {"shape": dict(b=p["b"], lens=h_lens, gamma=gamma,
                                    **heads),
                      "graph": f"verify {key}",
                      "library_graph": f"verify {key} sdpa",
                      "host_ms": h_ms, "plain_ms": h_plain_ms,
                      "bound_ms": h_bms, "bound_by": h_by}
    # the serving path runs gamma = SPEC["gamma"]: its row goes in the line
    main = next(r for r in results if r["gamma"] == SPEC["gamma"])
    main.update(dense)
    main["max_abs_err"] = max(main["max_abs_err"], m_err)
    main["moe"] = {"shape": dict(b=p["b"], lens=m_lens, gamma=gamma,
                                 **MOE_HEADS),
                   "graph": "verify moe", "library_graph": "verify moe sdpa",
                   "host_ms": m_ms, "plain_ms": m_plain_ms,
                   "bound_ms": m_bms, "bound_by": m_by}
    return main


# --------------------------------------------------------------- composed --

def composed_phase(torch, dev, decode_args):
    """Kernel 5 on the decode phase's main inputs: int8 q from
    quantize(q, s_q) on the card, then the composed kernel, which must
    equal the fused kernel bit for bit and the plain version within
    tolerance."""
    from repro_torch.core import paged_kv
    from repro_torch.core import quantization as qlib
    from repro_torch.core.lut import LUTConfig
    from repro_torch.kernels import splitmax_decode as K

    cfg = LUTConfig(scale_z=8.0 / 127)
    q, kp, vp, table, m_z, s_q, s_v, lens_t, exp_lut, recip_lut = decode_args
    q_q = qlib.quantize(q, s_q[:, None, None])
    args = [q_q, kp, vp, table, m_z, s_v, lens_t, exp_lut, recip_lut]
    errs = []
    for window in (None, 48):
        ker = K.splitmax_decode_paged_cuda(*args, cfg=cfg, window=window)
        fused = K.splitmax_decode_fused_paged_cuda(*decode_args, cfg=cfg,
                                                   window=window)
        plain = K.splitmax_decode_paged_plain(*args, cfg=cfg, window=window)
        exact = K.splitmax_decode_paged_plain(*args, cfg=cfg, window=window,
                                              exact=True)
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
        check(torch.equal(ker, exact), f"composed window {window}: kernel != "
              f"the exact=True plain version")
        check(torch.equal(ker, ker2), f"composed window {window}: output "
              f"depends on the trash block")
        errs.append(err)
        print(f"[composed] window {window}: == exact oracle, max_abs_err "
              f"{err:.3g} (tol {tol:.3g}), == fused kernel bit for bit")
    MAIN_ARGS["splitmax_decode_paged"] = (args, dict(cfg=cfg),
                                          tolerance(float(s_v)))
    GRAPHED["composed"] = lambda: K.splitmax_decode_paged_cuda(*args,
                                                                cfg=cfg)
    ms = time_ms(torch, GRAPHED["composed"])
    plain_ms = time_ms(torch, lambda: K.splitmax_decode_paged_plain(
        *args, cfg=cfg), iters=10)
    b, hq, d = q.shape
    hkv, bk = kp.shape[1], kp.shape[2]
    lens = lens_t.tolist()
    tiles = sum(paged_kv.blocks_per_seq(n, bk) for n in lens)
    n_bytes = (b * hq * d                       # int8 q
               + 2 * hkv * d * sum(lens)        # int8 k, v at live positions
               + 4 * tiles + 4 * b * 2 + 4      # table, lens, m_z, s_v
               + 4 * b * hq * d                 # f32 out
               + 4 * (256 + cfg.recip_table_size))
    bms, by = bound_ms(n_bytes, sum(lens) * hq * 6 * d)
    print(f"[composed] main lens {lens}: kernel host-inclusive {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")
    return {"name": "splitmax_decode_paged", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/splitmax_decode.cu",
            "replaces": "src/repro/kernels/splitmax_decode.py:709",
            "path": "paged decode steps, --fused off (self and cross)",
            "max_abs_err": max(errs), "exact_equal": True,
            "graph": "composed", "library_graph": "decode sdpa",
            "host_ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by}


# ------------------------------------------------------------ dense decode --

def dense_case(torch, gen, dev, cfg, exp_lut, recip_lut, lens, hq, hkv,
               s_max, d, gamma=None):
    """A dense (B, Hkv, S_max, D) int8 cache and f32 queries of one token
    (or ``gamma``) per slot: the fused kernels' argument list."""
    from repro_torch.core import quantization as qlib
    from repro_torch.kernels import ops
    b = len(lens)
    k = int8_like(torch, gen, (b, hkv, s_max, d), dev)
    v = int8_like(torch, gen, (b, hkv, s_max, d), dev)
    shape = (b, hq, d) if gamma is None else (b, hq, gamma, d)
    q = torch.randn(shape, generator=gen, device=dev)
    s_q = (qlib.absmax_scale(q, axis=(1, 2)).reshape(-1) if gamma is None
           else qlib.absmax_scale(q, axis=(1, 3))[:, 0, :, 0].contiguous())
    s_k, s_v = pool_scales(torch, dev)
    return [q, k, v, ops.requant_multiplier(s_q, s_k, d, cfg), s_q, s_v,
            torch.tensor(lens, dtype=torch.int32, device=dev), exp_lut,
            recip_lut]


def dense_to_pool(torch, gen, k, v, bk):
    """The dense cache ``k, v (B, Hkv, S, D)`` scattered into a shuffled
    pool of ``bk``-position blocks: (k_pages, v_pages, table) holding the
    same logical K/V."""
    b, hkv, s, d = k.shape
    mb = -(-s // bk)
    nb = 1 + b * mb
    table = (torch.randperm(nb - 1, generator=gen, device=k.device) + 1
             ).reshape(b, mb).to(torch.int32)
    pools = []
    for x in (k, v):
        tiles = torch.nn.functional.pad(x, (0, 0, 0, mb * bk - s))
        pool = torch.zeros((nb, hkv, bk, d), dtype=torch.int8,
                           device=k.device)
        pool[table.long()] = tiles.reshape(b, hkv, mb, bk, d).permute(
            0, 2, 1, 3, 4)
        pools.append(pool)
    return pools[0], pools[1], table


def dense_decode_bytes(b, hq, hkv, d, lens, q_bytes, cfg):
    return (q_bytes * b * hq * d            # q (f32 fused, int8 composed)
            + 2 * hkv * d * sum(lens)       # int8 k, v at live positions
            + 4 * b * 4                     # lens, m_z, s_q, s_v
            + 4 * b * hq * d                # f32 out
            + 4 * (256 + cfg.recip_table_size))


def dense_decode_phase(torch, F, dev):
    """Kernels 4 and 6 (fused and composed dense decode) against their plain
    versions, each other and the paged kernel on the same K/V."""
    from repro_torch.core import quantization as qlib
    from repro_torch.core.attention import luts_for
    from repro_torch.core.lut import LUTConfig
    from repro_torch.kernels import splitmax_decode as K

    cfg = LUTConfig(scale_z=8.0 / 127)
    exp_lut, recip_lut = luts_for(cfg.scale_z, dev)
    p = DENSE
    hq, hkv, d, s_max = p["hq"], p["hkv"], p["d"], p["s_max"]
    bk = K.DENSE_BLOCK_K
    gen = torch.Generator(device=dev).manual_seed(7)

    def composed_args(args):
        q, k, v, m_z, s_q, s_v, lens_t, el, rl = args
        return [qlib.quantize(q, s_q[:, None, None]), k, v, m_z, s_v, lens_t,
                el, rl]

    def compare(args, what, window=None, idle=()):
        fused = K.splitmax_decode_fused_cuda(*args, cfg=cfg, window=window)
        plain = K.splitmax_decode_fused_plain(*args, cfg=cfg, window=window)
        cargs = composed_args(args)
        comp = K.splitmax_decode_cuda(*cargs, cfg=cfg, window=window)
        comp_plain = K.splitmax_decode_plain(*cargs, cfg=cfg, window=window)
        exact = K.splitmax_decode_fused_plain(*args, cfg=cfg, window=window,
                                              exact=True)
        comp_exact = K.splitmax_decode_plain(*cargs, cfg=cfg, window=window,
                                             exact=True)
        q, k, v, m_z, s_q, s_v, lens_t, el, rl = args
        kp, vp, table = dense_to_pool(torch, gen, k, v, bk)
        paged = K.splitmax_decode_fused_paged_cuda(
            q, kp, vp, table, m_z, s_q, s_v, lens_t, el, rl, cfg=cfg,
            window=window)
        torch.cuda.synchronize()
        err = float((fused - plain).abs().max())
        cerr = float((comp - comp_plain).abs().max())
        tol = tolerance(float(s_v))
        check(bool(torch.isfinite(fused).all()), f"dense {what}: non-finite")
        check(err <= tol, f"dense fused {what}: max|kernel-plain| {err:.3g} "
              f"> {tol:.3g}")
        check(cerr <= tol, f"dense composed {what}: max|kernel-plain| "
              f"{cerr:.3g} > {tol:.3g}")
        check(torch.equal(comp, fused), f"dense {what}: composed differs "
              f"from fused on quantize(q, s_q)")
        check(torch.equal(fused, exact) and torch.equal(comp, comp_exact),
              f"dense {what}: a kernel != its exact=True plain version")
        check(torch.equal(fused, paged), f"dense {what}: differs from the "
              f"paged kernel on the same K/V at block_k {bk}")
        for i in idle:
            check(not fused[i].any(), f"dense {what}: idle slot {i} not zero")
        print(f"[dense] {what}: lens {args[6].tolist()}, S_max "
              f"{args[1].shape[2]}, window {window}: == exact oracles, "
              f"max_abs_err fused {err:.3g} composed {cerr:.3g} (tol "
              f"{tol:.3g}), composed == fused == paged bit for bit")
        return max(err, cerr)

    def make(lens, s, heads=(hq, hkv, d)):
        return dense_case(torch, gen, dev, cfg, exp_lut, recip_lut, lens,
                          heads[0], heads[1], s, heads[2])

    # length 1, tile boundaries, an idle slot, the cache's ragged last tile
    edge_lens = [1, bk, bk + 1, 2 * bk, 0, 250, s_max - 1, s_max]
    compare(make(edge_lens, s_max), "edges", idle=(4,))
    compare(make(edge_lens, s_max), "edges window 48", window=48, idle=(4,))
    compare(make([36, 17, 1], 36, (8, 2, 16)), "smoke heads d 16")
    compare(make([100, 99, 64], 100), "S_max 100")

    lens = torch.randint(p["lens"][0], p["lens"][1] + 1, (p["b"],),
                         generator=gen, device=dev).tolist()
    args = make(lens, s_max)
    errs = [compare(args, "main"), compare(args, "main window 48", window=48)]
    cargs = composed_args(args)
    b = p["b"]
    GRAPHED["dense sdpa"] = sdpa_decode_yardstick(torch, F, gen, dev, b, hq,
                                                  d, [[n] for n in lens])
    rows = []
    for name, line, fn, plain_fn, a, q_bytes, path in (
            ("splitmax_decode_fused", 672, K.splitmax_decode_fused_cuda,
             K.splitmax_decode_fused_plain, args, 4, "dense decode steps"),
            ("splitmax_decode", 642, K.splitmax_decode_cuda,
             K.splitmax_decode_plain, cargs, 1,
             "dense decode steps, --fused off")):
        MAIN_ARGS[name] = (a, dict(cfg=cfg), tolerance(float(a[-4])))
        GRAPHED[name] = lambda fn=fn, a=a: fn(*a, cfg=cfg)
        ms = time_ms(torch, GRAPHED[name])
        plain_ms = time_ms(torch, lambda: plain_fn(*a, cfg=cfg), iters=10)
        bms, by = bound_ms(dense_decode_bytes(b, hq, hkv, d, lens, q_bytes,
                                              cfg),
                           sum(lens) * hq * 6 * d)
        print(f"[dense] {name} main lens {lens}: kernel host-inclusive "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms "
              f"({by})")
        rows.append({"name": name, "route": "cuda",
                     "source": ("src/repro_torch/kernels/csrc/"
                                "splitmax_decode.cu"),
                     "replaces": ("src/repro/kernels/splitmax_decode.py:"
                                  f"{line}"),
                     "path": path, "max_abs_err": max(errs),
                     "exact_equal": True, "graph": name,
                     "library_graph": "dense sdpa", "host_ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by})
    return rows


def dense_verify_phase(torch, F, dev):
    """Kernel 7 (dense verify) against its plain version; every row bit for
    bit kernel 4 at its effective length."""
    from repro_torch.core.attention import luts_for
    from repro_torch.core.lut import LUTConfig
    from repro_torch.kernels import splitmax_decode as K

    cfg = LUTConfig(scale_z=8.0 / 127)
    exp_lut, recip_lut = luts_for(cfg.scale_z, dev)
    p = DENSE
    hq, hkv, d, s_max = p["hq"], p["hkv"], p["d"], p["s_max"]
    bk = K.DENSE_BLOCK_K
    gen = torch.Generator(device=dev).manual_seed(8)

    def case(lens, gamma, what, window=None, d=d):
        args = dense_case(torch, gen, dev, cfg, exp_lut, recip_lut, lens, hq,
                          hkv, s_max, d, gamma)
        q, k, v, m_z, s_q, s_v, lens_t, el, rl = args
        ker = K.splitmax_decode_fused_verify_cuda(*args, cfg=cfg,
                                                  window=window)
        plain = K.splitmax_decode_fused_verify_plain(*args, cfg=cfg,
                                                     window=window)
        exact = K.splitmax_decode_fused_verify_plain(*args, cfg=cfg,
                                                     window=window, exact=True)
        check(torch.equal(ker, exact), f"dense verify {what}: kernel != the "
              f"exact=True plain version")
        rows = [[q[:, :, t].contiguous(), k, v, m_z[:, t].contiguous(),
                 s_q[:, t].contiguous(), s_v,
                 torch.clamp_min(lens_t - (gamma - 1 - t), 0), el, rl]
                for t in range(gamma)]
        for t, row in enumerate(rows):
            dec = K.splitmax_decode_fused_cuda(*row, cfg=cfg, window=window)
            check(torch.equal(ker[:, :, t], dec), f"dense verify {what}: "
                  f"token {t} differs from kernel 4 at its effective length")
        torch.cuda.synchronize()
        err = float((ker - plain).abs().max())
        tol = tolerance(float(s_v))
        check(bool(torch.isfinite(ker).all()), f"dense verify {what}: "
              f"non-finite")
        check(err <= tol, f"dense verify {what}: max|kernel-plain| {err:.3g} "
              f"> {tol:.3g}")
        for i, n in enumerate(lens):
            check(n > 0 or not ker[i].any(), f"dense verify {what}: idle slot "
                  f"{i} not zero")
        print(f"[dense-verify] {what}: lens {lens}, gamma {gamma}, d {d}, "
              f"window {window}: == exact oracle, max_abs_err {err:.3g} (tol "
              f"{tol:.3g}), rows == kernel 4")
        return args, rows, err

    for gamma in p["gammas"]:
        edges = [gamma, bk + gamma // 2, s_max, 250, gamma, 2 * bk, 96, 33]
        case(edges, gamma, "edges")
        case(edges, gamma, "edges window 48", window=48)

    results = []
    for gamma in p["gammas"]:
        lens = torch.randint(p["lens"][0], p["lens"][1] + 1, (p["b"],),
                             generator=gen, device=dev).tolist()
        args, rows, err = case(lens, gamma, "main")
        if gamma == SPEC["gamma"]:
            MAIN_ARGS["splitmax_decode_fused_verify"] = (
                args, dict(cfg=cfg), tolerance(float(args[5])))
        key = f"dense verify g{gamma}"
        GRAPHED[key] = (lambda a=args: K.splitmax_decode_fused_verify_cuda(
            *a, cfg=cfg))
        ms = time_ms(torch, GRAPHED[key])
        plain_ms = time_ms(torch, lambda: K.splitmax_decode_fused_verify_plain(
            *args, cfg=cfg), iters=10)

        def decodes(rows=rows):
            for row in rows:
                K.splitmax_decode_fused_cuda(*row, cfg=cfg)

        GRAPHED[f"{key} decodes"] = decodes
        b = p["b"]
        q_lens = [[n - (gamma - 1 - t) for t in range(gamma)] for n in lens]
        GRAPHED[f"{key} sdpa"] = sdpa_decode_yardstick(torch, F, gen, dev, b,
                                                       hq, d, q_lens)
        pairs = hq * sum(sum(row) for row in q_lens)
        n_bytes = (4 * b * hq * gamma * d           # f32 q
                   + 2 * hkv * d * sum(lens)        # int8 k, v, read once
                   + 4 * b + 2 * 4 * b * gamma + 4  # lens, m_z, s_q, s_v
                   + 4 * b * hq * gamma * d         # f32 out
                   + 4 * (256 + cfg.recip_table_size))
        bms, by = bound_ms(n_bytes, pairs * 6 * d)
        print(f"[dense-verify] main gamma {gamma}: kernel host-inclusive "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms "
              f"({by})")
        results.append({
            "name": "splitmax_decode_fused_verify", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/splitmax_verify.cu",
            "replaces": "src/repro/kernels/splitmax_decode.py:780",
            "path": None, "gamma": gamma, "max_abs_err": err,
            "exact_equal": True, "graph": key,
            "library_graph": f"{key} sdpa", "decodes_graph": f"{key} decodes",
            "host_ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by})
    for gamma, wide in FULL_GROUP:
        # group 8 x T x D past the first kernel's thread cap; slot 4 idle
        edges = [gamma, bk + gamma // 2, s_max, 250, 0, 2 * bk, 96, 33]
        for window in (None, 48):
            case(edges, gamma, f"full group d {wide}", window=window, d=wide)
        lens = torch.randint(p["lens"][0], p["lens"][1] + 1, (p["b"],),
                             generator=gen, device=dev).tolist()
        args = case(lens, gamma, f"full group d {wide} main", d=wide)[0]
        GRAPHED[f"dense verify g{gamma} d{wide}"] = (
            lambda a=args: K.splitmax_decode_fused_verify_cuda(*a, cfg=cfg))
    return next(r for r in results if r["gamma"] == SPEC["gamma"])


# ---------------------------------------------------------------- int8 GEMM --

def int8_gemm_phase(torch, dev):
    """Kernel 8 bit for bit against its plain version, with and without the
    requant epilogue; timed at TinyLlama's widths whole, and as its two
    launches (the K-major pre-pass alone, the body alone on a prepared
    ``w_t``), beside torch._int_mm (cuBLASLt, the same int32 function; a
    yardstick the port never calls) with w as given (N-major) and K-major;
    each of these also L2-cold.  Every call to the kernel adds one to the
    body's count and one to the pre-pass's."""
    from repro_torch.kernels import int8_matmul as K

    gen = torch.Generator(device=dev).manual_seed(9)
    out = None
    for m, k, n in GEMMS:
        x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        x[0], w[:, 0] = -128, -128              # |acc| up to K * 2^14
        mult = torch.tensor(0.05 / k, device=dev)
        for requant in (None, mult):
            before = K.launches, K.pack_launches
            got = K.int8_matmul_cuda(x, w, requant)
            want = K.int8_matmul_plain(x, w, requant)
            torch.cuda.synchronize()
            check((K.launches, K.pack_launches) == (before[0] + 1,
                                                    before[1] + 1),
                  f"int8 GEMM {m}x{k}x{n}: body and pre-pass counts moved "
                  f"{K.launches - before[0]}, {K.pack_launches - before[1]}"
                  f" for one call, not 1 and 1")
            check(torch.equal(got, want), f"int8 GEMM {m}x{k}x{n} requant="
                  f"{requant is not None}: differs from the plain version "
                  f"({int((got != want).sum())} entries)")
            if requant is None:
                acc_max = int(want.abs().max())
        print(f"[int8-gemm] {m}x{k}x{n}: int32 and requant int8 == plain bit "
              f"for bit (max |acc| {acc_max})")
        if (m, k, n) != GEMMS[-1]:
            continue
        GRAPHED["int8 gemm"] = lambda: K.int8_matmul_cuda(x, w)
        GRAPHED["int8 gemm requant"] = lambda: K.int8_matmul_cuda(x, w, mult)
        GRAPHED["int8 gemm _int_mm"] = lambda: torch._int_mm(x, w)
        w_t = K.pack_k_major_cuda(w)
        w_kmajor = w.t().contiguous().t()
        GRAPHED["int8 gemm pre-pass"] = lambda: K.pack_k_major_cuda(w)
        GRAPHED["int8 gemm body"] = lambda: K.int8_matmul_packed_cuda(x, w_t)
        GRAPHED["int8 gemm _int_mm kmajor"] = (
            lambda: torch._int_mm(x, w_kmajor))
        # L2-cold: the same calls, each on its own copy of the operands,
        # COLD_COPIES of them, so a copy's bytes have left the 50 MB L2 by
        # its next turn
        xs = [x.clone() for _ in range(COLD_COPIES)]
        ws = [w.clone() for _ in range(COLD_COPIES)]
        GRAPHED["int8 gemm cold"] = rotating(K.int8_matmul_cuda,
                                             list(zip(xs, ws)))
        GRAPHED["int8 gemm pre-pass cold"] = rotating(
            K.pack_k_major_cuda, [(v,) for v in ws])
        GRAPHED["int8 gemm body cold"] = rotating(
            K.int8_matmul_packed_cuda,
            [(u, K.pack_k_major_cuda(v)) for u, v in zip(xs, ws)])
        GRAPHED["int8 gemm _int_mm cold"] = rotating(torch._int_mm,
                                                     list(zip(xs, ws)))
        GRAPHED["int8 gemm _int_mm kmajor cold"] = rotating(
            torch._int_mm, [(u, v.t().contiguous().t())
                            for u, v in zip(xs, ws)])
        ms = time_ms(torch, GRAPHED["int8 gemm"], iters=20)
        plain_ms = time_ms(torch, lambda: K.int8_matmul_plain(x, w), iters=5,
                           warm=1)
        got = K.int8_matmul_cuda(x, w)
        check(torch.equal(torch._int_mm(x, w), got)
              and torch.equal(torch._int_mm(x, w_kmajor), got),
              "int8 GEMM: torch._int_mm disagrees with the kernel")
        check(torch.equal(K.int8_matmul_packed_cuda(x, w_t), got)
              and torch.equal(w_t, K.pack_k_major_plain(w)),
              "int8 GEMM: the pre-pass or the body alone disagrees")
        bms, by = bound_ms(m * k + k * n + 4 * m * n, 2 * m * k * n)
        rq_bms, rq_by = bound_ms(m * k + k * n + m * n + 4, 2 * m * k * n)
        pre_bms, _ = bound_ms(k * n + n * w_t.shape[1], 0)
        print(f"[int8-gemm] {m}x{k}x{n}: kernel host-inclusive {ms:.4f} ms, "
              f"requant bound {rq_bms:.5f} ms ({rq_by}), plain f64 "
              f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by}), pre-pass "
              f"bound {pre_bms:.5f} ms (bytes)")
        out = {"name": "int8_matmul", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
               "replaces": "src/repro/kernels/int8_matmul.py:54",
               "path": None, "shape": [m, k, n], "max_abs_err": 0.0,
               "exact_equal": True, "graph": "int8 gemm",
               "library_graph": "int8 gemm _int_mm",
               "requant_graph": "int8 gemm requant",
               "transpose_graph": "int8 gemm pre-pass",
               "body_graph": "int8 gemm body",
               "library_kmajor_graph": "int8 gemm _int_mm kmajor",
               "cold_graph": "int8 gemm cold",
               "transpose_cold_graph": "int8 gemm pre-pass cold",
               "body_cold_graph": "int8 gemm body cold",
               "library_cold_graph": "int8 gemm _int_mm cold",
               "library_kmajor_cold_graph": "int8 gemm _int_mm kmajor cold",
               "host_ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
               "bound_by": by, "requant_bound_ms": rq_bms,
               "transpose_bound_ms": pre_bms}
    return out


# DeepSeek-67B's four (K, N) of a layer's seven int8 linears (q and o, k and
# v, in and gate, out), each linear's count, and the decode step's rows
W8_SHAPES = {(8192, 8192): 2, (8192, 1024): 2, (8192, 22016): 2,
             (22016, 8192): 1}
W8_ROWS = 16
W8_SUBS = tuple(f"w8 {k}x{n}" for k, n in list(W8_SHAPES)[1:])


def w8_linear_phase(torch, dev):
    """Kernel 9, the int8-weight linear, at DeepSeek-67B's shapes and the
    chat cell's 16 rows: bit for bit ``linear_weight``'s dequant on one-hot
    rows and within cuBLAS's error on random ones, timed by graph replay
    beside its bound (the int8 bytes at 3.35 TB/s) and the path it replaces
    (``torch.mul`` into a bf16 weight, then ``x @ w``; the plain version's
    function, which the port runs everywhere else).  Returns the (8192,
    8192) entry with the other shapes under ``W8_SUBS``."""
    from repro_torch.kernels import w8_linear as W8
    from repro_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(32)
    entries = {}
    for (k, n), count in W8_SHAPES.items():
        w_q = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8)
        w_s = torch.rand((1, 1), generator=gen, device=dev) * 0.02
        x = torch.randn((W8_ROWS, k), generator=gen, device=dev
                        ).to(torch.bfloat16)
        w = L.linear_weight({"w_q": w_q, "w_s": w_s}, torch.bfloat16)
        ks = torch.randint(0, k, (W8_ROWS,), generator=gen, device=dev)
        one_hot = torch.zeros_like(x)
        one_hot[torch.arange(W8_ROWS, device=dev), ks] = 1
        check(torch.equal(W8.w8_linear_cuda(one_hot, w_q, w_s), w[ks]),
              f"w8_linear {k}x{n}: one-hot rows differ from the dequant")
        exact = x.double() @ w.double()
        got = W8.w8_linear_cuda(x, w_q, w_s)
        err = float((got.double() - exact).abs().max())
        lib_err = float(((x @ w).double() - exact).abs().max())
        check(err <= 2 * lib_err, f"w8_linear {k}x{n}: error {err:.3g} over "
              f"twice cuBLAS's {lib_err:.3g}")
        key = f"w8 {k}x{n}"
        GRAPHED[key] = lambda x=x, w_q=w_q, w_s=w_s: W8.w8_linear_cuda(
            x, w_q, w_s)
        GRAPHED[f"{key} dequant+gemm"] = lambda x=x, w_q=w_q, w_s=w_s: (
            x @ L.linear_weight({"w_q": w_q, "w_s": w_s}, torch.bfloat16))
        ms = time_ms(torch, GRAPHED[key], iters=20)
        plain_ms = time_ms(torch, lambda: W8.w8_linear_plain(x, w_q, w_s),
                           iters=5, warm=1)
        bms, by = bound_ms(k * n, 0)
        print(f"[w8-linear] {k}x{n} (x{count} a layer) at {W8_ROWS} rows: "
              f"one-hot == dequant bit for bit, max error {err:.3g} (cuBLAS "
              f"{lib_err:.3g}), kernel host-inclusive {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by}); K split in "
              f"{-(-k // W8.split_rows(k, n))}")
        entries[key] = {"shape": [W8_ROWS, k, n], "per_layer": count,
                        "max_abs_err": err, "exact_equal": False,
                        "graph": key, "library_graph": f"{key} dequant+gemm",
                        "host_ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": by}
    first = entries.pop(f"w8 {8192}x{8192}")
    first.update({"name": "w8_linear", "route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/w8_linear.cu",
                  "replaces": None,
                  "path": "models/layers.py: linear_apply (w8_kernel_takes)"},
                 **entries)
    return first


# ------------------------------------------------------ graph-replay times --

def options_phase(torch, dev, kernels):
    """The reference's two kernel options on every split-softmax kernel's
    main inputs (``MAIN_ARGS``): the ``exact_recip`` instance (a division
    in the finalize) bit for bit the plain version's ``exact=True`` with
    ``exact_recip``, within ``tolerance`` of its default plain version, and
    the LUT instance within the reference's ``RECIP_LUT_REL_ERR`` of it;
    then the kernel reading the ``lut_mode="compute"`` table (built on the
    CPU, as ``core.attention.luts_for`` serves it) bit for bit its plain
    version on that table.  Each ``exact_recip`` instance is timed in the
    graph phase; its entry goes under the kernel's ``"exact_recip"``."""
    from repro_torch.core.attention import luts_for
    from repro_torch.kernels import splitmax_attn, splitmax_decode

    scale_z = 8.0 / 127
    exp_lut = luts_for(scale_z, dev)[0]
    exp_compute = luts_for(scale_z, dev, "compute")[0]
    n_diff = int((exp_compute != exp_lut).sum())
    print(f"[options] compute table at scale_z {scale_z:.6g} (the served "
          f"configs'): {n_diff} of 256 entries differ from the one-hot "
          f"mode's f64-built table")
    for k in kernels:
        name = k["name"]
        if name not in MAIN_ARGS:
            continue
        args, kw, tol = MAIN_ARGS.pop(name)
        mod = splitmax_attn if name == "splitmax_attention" else \
            splitmax_decode
        kern, plain = (getattr(mod, f"{name}_cuda"),
                       getattr(mod, f"{name}_plain"))
        got = kern(*args, exact_recip=True, **kw)
        exact = plain(*args, exact_recip=True, exact=True, **kw)
        default = plain(*args, exact_recip=True, **kw)
        lut = kern(*args, **kw)
        c_args = [exp_compute if a is exp_lut else a for a in args]
        c_got = kern(*c_args, **kw)
        c_exact = plain(*c_args, exact=True, **kw)
        torch.cuda.synchronize()
        err = float((got - default).abs().max())
        rel = float((lut - got).abs().max() / got.abs().max())
        check(torch.equal(got, exact), f"{name} exact_recip: kernel != the "
              f"exact=True plain version")
        check(err <= tol, f"{name} exact_recip: max|kernel-plain| {err:.3g} "
              f"> {tol:.3g}")
        check(rel < RECIP_LUT_REL_ERR, f"{name}: the LUT instance is "
              f"{rel:.3g} of the scale from the exact_recip one")
        check(torch.equal(c_got, c_exact), f"{name} compute mode: kernel != "
              f"the exact=True plain version on the compute table")
        key = f"{name} exact_recip"
        GRAPHED[key] = (lambda f=kern, a=args, w=kw:
                        f(*a, exact_recip=True, **w))
        ms = time_ms(torch, GRAPHED[key])
        plain_ms = time_ms(torch, lambda: plain(*args, exact_recip=True,
                                                **kw), iters=10)
        k["exact_recip"] = {"graph": key, "library_graph": k["library_graph"],
                            "host_ms": ms, "plain_ms": plain_ms,
                            "bound_ms": k["bound_ms"],
                            "bound_by": k["bound_by"], "max_abs_err": err}
        print(f"[options] {name}: exact_recip instance == exact oracle, "
              f"max_abs_err {err:.3g} (tol {tol:.3g}), LUT instance within "
              f"{rel:.3g} of its scale (bound {RECIP_LUT_REL_ERR:.3g}), "
              f"host-inclusive {ms:.4f} ms, plain {plain_ms:.4f} ms; "
              f"compute mode == exact oracle")
    check(not MAIN_ARGS, f"options: no kernel entry for {sorted(MAIN_ARGS)}")


def graph_phase(torch, dev, kernels):
    """Every closure in GRAPHED timed by graph replay, 7 rounds interleaved,
    beside the launch floor (a replayed one-element ``add_``); each kernel
    entry's ``*_graph`` keys become its times: ``ms`` (median) and
    ``ms_range`` (min, max), ``library_ms``, ``decodes_ms``, ``requant_ms``,
    ``transpose_ms``, ``body_ms``, ``library_kmajor_ms`` and the int8
    GEMM's L2-cold ``*_cold_ms``."""
    one = torch.zeros(1, device=dev)
    fns = dict(GRAPHED, **{"launch floor": lambda: one.add_(1)})
    times = graph_rounds(torch, fns)
    GRAPHED.clear()
    floor = times["launch floor"][0]
    print(f"[graph] device time per call, CUDA-graph replay of "
          f"{GRAPH_ITERS} calls, median (min-max) of {GRAPH_ROUNDS} rounds "
          f"interleaved:")
    for name, (med, lo, hi) in times.items():
        print(f"[graph]   {name:28s} {med:.5f} ms ({lo:.5f}-{hi:.5f})")

    def fill(entry):
        for key in [k for k in entry if k.endswith("graph")]:
            med, lo, hi = times[entry.pop(key)]
            field = "ms" if key == "graph" else key[:-len("graph")] + "ms"
            entry[field] = med
            entry[field + "_range"] = [lo, hi]
        entry["launch_floor_ms"] = floor
        print(f"[graph] {entry.get('name', entry.get('shape'))}: kernel "
              f"{entry['ms']:.5f} ms ({entry['ms_range'][0]:.5f}-"
              f"{entry['ms_range'][1]:.5f}), host-inclusive "
              f"{entry['host_ms']:.5f} ms, bound {entry['bound_ms']:.5f} ms "
              f"({entry['bound_by']}), launch floor {floor:.5f} ms, "
              f"yardstick {entry['library_ms']:.5f} ms")

    for k in kernels:
        fill(k)
        for sub in ("reprefill", "int8_check", "moe", *DENSE_HEADS,
                    "exact_recip", *W8_SUBS):
            if sub in k:
                fill(k[sub])
    return floor


# ------------------------------------------------------- model reference --

def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def smoke_paged_logits(torch, params, cfg, tokens, device, steps: int = 8):
    """Paged prefill of ``tokens (1, S)`` and ``steps`` greedy decode steps
    on ``device``: the stacked logits, on the CPU."""
    from repro_torch.models import transformer as T
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
    for _ in range(steps):
        logits, cache = T.decode_step(p, nxt, cfg, cache)
        outs.append(logits)
        nxt = torch.argmax(logits, -1)
    return torch.stack(outs).cpu()


def smoke_reference_phase(torch, dev):
    """The port at the smoke size, kernels on the card vs plain versions on
    the CPU, same weights: paged prefill logits and 8 decode steps, a
    sliding-window ring buffer's prefill and 33 decode steps, and dense
    serving tokens.  Then f32 speculative serving on the card against plain
    serving on the card, token for token (TF32 is off:
    ``resolve_device``)."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    cfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    cpu = torch.device("cpu")
    params = T.init_params(cfg, seed=0, device=cpu)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 20))
    gpu = smoke_paged_logits(torch, params, cfg, tokens, dev)
    ref = smoke_paged_logits(torch, params, cfg, tokens, cpu)
    err = float((gpu - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(gpu).all()), "smoke model: non-finite logits")
    check(err <= 2e-3 * scale, f"smoke model: max|gpu-cpu| logits {err:.3g} "
          f"> 2e-3 * {scale:.3g}")
    print(f"[model] smoke size, card vs CPU plain path: max|logit diff| "
          f"{err:.3g} (logits up to {scale:.3g}; tol 2e-3 of that)")

    # window 16 over a 16-position ring, a 32-token prompt, 33 decode steps:
    # the write index wraps twice
    wcfg = cfg.replace(window=16)
    wtokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))

    def run_ring(device):
        p = tree_to(params, device)
        cache = T.make_cache(wcfg, 2, 16, device=device)
        last, cache = T.prefill(p, torch.as_tensor(wtokens, device=device),
                                wcfg, cache)
        outs = [last]
        nxt = torch.argmax(last, -1)
        for _ in range(33):
            logits, cache = T.decode_step(p, nxt, wcfg, cache)
            outs.append(logits)
            nxt = torch.argmax(logits, -1)
        return torch.stack(outs).cpu()

    gpu, ref = run_ring(dev), run_ring(cpu)
    err = float((gpu - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(gpu).all()), "smoke ring: non-finite logits")
    check(err <= 2e-3 * scale, f"smoke ring buffer: max|gpu-cpu| logits "
          f"{err:.3g} > 2e-3 * {scale:.3g}")
    print(f"[model] smoke ring buffer (window 16, cache 16, 32-token prompt, "
          f"33 steps), card vs CPU: max|logit diff| {err:.3g} (logits up to "
          f"{scale:.3g}; tol 2e-3 of that)")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 20, dtype=np.int32)
               for _ in range(6)]
    gens = [int(g) for g in rng.integers(6, 13, 6)]
    p = tree_to(params, dev)
    for fused in (True, False):
        c = cfg.replace(attn_fused=fused)
        on_card = srv.serve(p, c, prompts, slots=3, gen=12, gens=gens,
                            cache_kind="dense")
        on_cpu = srv.serve(params, c, prompts, slots=3, gen=12, gens=gens,
                           cache_kind="dense")
        check(on_card["finished"] == on_cpu["finished"],
              f"smoke dense serving (fused={fused}): card tokens differ from "
              f"the CPU's")
        check(on_card["batch_prefills"] == on_cpu["batch_prefills"] > 1,
              "smoke dense serving: batch prefills differ")
    print("[model] smoke size f32 dense serving (fused, composed): card "
          "tokens == CPU tokens")
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

def churn(cfg, requests: int = SERVE["requests"], gen: int = SERVE["gen"]):
    """The churn workload: SERVE's prompts and staggered gens in [gen // 2,
    gen], seed 0; fewer ``requests`` are the churn's first prompts."""
    import numpy as np
    rng = np.random.default_rng(SERVE["seed"])
    prompts = [rng.integers(0, cfg.vocab_size, SERVE["prompt_len"],
                            dtype=np.int32) for _ in range(requests)]
    gens = [int(g) for g in rng.integers(gen // 2, gen + 1, requests)]
    return prompts, gens


def check_served(stats, gens, vocab, what, overshoot: int = 0):
    """Every request served with its tokens in the vocab, none failed, no
    block leaked.  ``overshoot`` 1 admits the dense scheduler's one extra
    token for a request whose last token comes from a re-prefill, which
    the reference emits too (ROADMAP queue 3)."""
    check(stats["served"] == len(gens),
          f"{what}: served {stats['served']} of {len(gens)}")
    check(stats["leaked_blocks"] == 0,
          f"{what}: {stats['leaked_blocks']} blocks leaked")
    check(not stats.get("failed"), f"{what}: failed {stats.get('failed')}")
    for rid, toks in stats["finished"].items():
        check(gens[rid] <= len(toks) <= gens[rid] + overshoot
              and all(0 <= t < vocab for t in toks),
              f"{what}: request {rid}: {len(toks)} tokens, want {gens[rid]} "
              f"in vocab")


def serve_phase(torch, dev, params, cfg):
    from repro_torch.kernels import splitmax_attn, splitmax_decode
    from repro_torch.launch import serve as srv

    prompts, gens = churn(cfg)
    kw = dict(slots=SERVE["slots"], gen=SERVE["gen"], gens=gens,
              block_k=SERVE["block_k"])
    # warm-up inside serve_paged, before its clock: one scratch-pool pass
    # (calibrating and plain prefill, a decode step of all 8 slots)
    splitmax_attn.launches = 0
    splitmax_decode.launches = 0
    stats = srv.serve_paged(params, cfg, prompts, warmup=True, **kw)
    torch.cuda.synchronize()
    n_prefill, n_decode = splitmax_attn.launches, splitmax_decode.launches

    check_served(stats, gens, cfg.vocab_size, "plain churn")
    n_warm = (stats["warmup_prefills"], stats["warmup_decode_steps"])
    check(n_warm == (2, 1), f"warm-up ran {n_warm} prefills and decodes")
    check(n_prefill == (stats["slot_prefills"] + n_warm[0]) * cfg.n_layers,
          f"prefill kernel launches {n_prefill} != ({stats['slot_prefills']} "
          f"admissions + {n_warm[0]} warm-up) x {cfg.n_layers} layers")
    check(n_decode == (stats["decode_steps"] + n_warm[1]) * cfg.n_layers,
          f"decode kernel launches {n_decode} != ({stats['decode_steps']} "
          f"steps + {n_warm[1]} warm-up) x {cfg.n_layers} layers")
    print(f"[serve] churn {SERVE}: served {stats['served']}, "
          f"{stats['total_tokens']} tokens in {stats['wall_s']:.3f} s, "
          f"{stats['tok_s']:.1f} tok/s, {stats['decode_steps']} decode steps, "
          f"p50/p99 step {stats['p50_step_ms']:.2f}/"
          f"{stats['p99_step_ms']:.2f} ms, leaked {stats['leaked_blocks']}, "
          f"launches prefill {n_prefill} decode {n_decode} (warm-up "
          f"included: {n_warm[0]} prefills, {n_warm[1]} decode step)")
    best = srv.serve_paged(params, cfg, prompts, repeats=2, **kw)
    check(best["finished"] == stats["finished"],
          "repeats=2: the kept run's tokens differ from the first run's")
    print(f"[serve] churn, best of repeats=2: {best['tok_s']:.1f} tok/s, "
          f"p50/p99 step {best['p50_step_ms']:.2f}/"
          f"{best['p99_step_ms']:.2f} ms; tokens == the first run's")
    profile_serving(torch, srv, params, cfg, prompts[:SERVE["slots"]])
    return stats, {"splitmax_attention": n_prefill,
                   "splitmax_decode_fused_paged": n_decode}


def pressure_phase(torch, dev, params, cfg, plain):
    """The churn over a pool of ``PRESSURE_POOL_SEQS`` sequences under both
    preemption policies: preemptions, every one resumed by a re-prefill
    (kernel 1 at B 1) and a replay through the decode batch, the plain
    churn's tokens bit for bit, no replay splice, no leak.  First, at full
    width, the calibrating request's re-admission recomputes the pool's
    scales bit for bit.  Returns kernel 1's launches over both runs."""
    from repro_torch.core import paged_kv
    from repro_torch.kernels import splitmax_attn, splitmax_decode
    from repro_torch.launch import serve as srv

    prompts, gens = churn(cfg)
    max_len = SERVE["prompt_len"] + SERVE["gen"] + 8
    engine = srv.make_engine(params, cfg, prompts, slots=2, max_len=max_len,
                             block_k=SERVE["block_k"])
    cache = engine.start_run()
    engine.admit(cache, 0, 0)
    scales = (cache["scale_k"].clone(), cache["scale_v"].clone())
    engine.admit(cache, 1, 1)
    cache = engine.release(cache, 0)
    engine.admit(cache, 0, 0)
    check(torch.equal(cache["scale_k"], scales[0])
          and torch.equal(cache["scale_v"], scales[1]),
          "pressure: the calibrating request's re-admission changed the "
          "pool's scales")
    del engine, cache
    print("[pressure] full width: the calibrating request re-admitted "
          "recomputes the pool's scales bit for bit")

    pool = 1 + PRESSURE_POOL_SEQS * paged_kv.blocks_per_seq(
        max_len, SERVE["block_k"])
    n_total = 0
    for policy in ("newest", "longest"):
        what = f"pressure churn ({policy}, pool {pool})"
        splitmax_attn.launches = splitmax_decode.launches = 0
        stats = srv.serve_paged(params, cfg, prompts, slots=SERVE["slots"],
                                gen=SERVE["gen"], gens=gens,
                                block_k=SERVE["block_k"], pool_blocks=pool,
                                preempt_policy=policy)
        torch.cuda.synchronize()
        n_pre, n_dec = splitmax_attn.launches, splitmax_decode.launches
        c = stats["health"]["counters"]
        check_served(stats, gens, cfg.vocab_size, what)
        check(stats["preemptions"] >= 1
              and stats["resumes"] == stats["preemptions"],
              f"{what}: {stats['preemptions']} preemptions, "
              f"{stats['resumes']} resumes")
        check(stats["finished"] == plain["finished"],
              f"{what}: tokens differ from the plain churn's")
        check(c.get("replay_splices", 0) == 0,
              f"{what}: {c.get('replay_splices')} replayed tokens re-derived "
              f"differently")
        check(stats["slot_prefills"] == SERVE["requests"] + stats["resumes"],
              f"{what}: {stats['slot_prefills']} slot prefills")
        check(n_pre == stats["slot_prefills"] * cfg.n_layers,
              f"{what}: prefill launches {n_pre} != "
              f"{stats['slot_prefills']} x {cfg.n_layers}")
        check(n_dec == stats["decode_steps"] * cfg.n_layers,
              f"{what}: decode launches {n_dec} != {stats['decode_steps']} "
              f"x {cfg.n_layers}")
        n_total += n_pre
        print(f"[pressure] {what}: served {stats['served']}, "
              f"{stats['total_tokens']} tokens in {stats['wall_s']:.3f} s, "
              f"{stats['tok_s']:.1f} tok/s (plain {plain['tok_s']:.1f}), "
              f"{stats['decode_steps']} decode steps (plain "
              f"{plain['decode_steps']}), p50/p99 step "
              f"{stats['p50_step_ms']:.2f}/{stats['p99_step_ms']:.2f} ms, "
              f"{stats['preemptions']} preemptions, {stats['resumes']} "
              f"resumes, {c['resumed_tokens_replayed']} tokens replayed, "
              f"{c['admission_stalls']} admission stalls, "
              f"{stats['slot_prefills']} slot prefills, high water "
              f"{stats['health']['pools']['kv']['high_water']} of {pool - 1} "
              f"blocks, leaked {stats['leaked_blocks']}, tokens == plain, "
              f"launches prefill {n_pre} decode {n_dec}")
    return n_total


def chaos_phase(torch, dev, params, cfg, plain):
    """``make chaos`` at full width: pool exhaustion, a scheduler delay and
    a NaN slot with a step deadline and the metrics document, through
    ``serve_paged`` and then ``serve_speculative`` (self-drafted, and by
    the target's first layers on a second pool)."""
    import tempfile
    from repro_torch.kernels import splitmax_attn, splitmax_decode as K
    from repro_torch.launch import faults
    from repro_torch.launch import serve as srv

    prompts, gens = churn(cfg)
    plan = faults.FaultPlan(**CHAOS)
    kw = dict(slots=SERVE["slots"], gen=SERVE["gen"], gens=gens,
              block_k=SERVE["block_k"], deadline_steps=CHAOS_DEADLINE_STEPS,
              fault_plan=plan)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "health.json"
        splitmax_attn.launches = K.launches = 0
        stats = srv.serve(params, cfg, prompts, metrics_json=str(path), **kw)
        torch.cuda.synchronize()
        n_pre, n_dec = splitmax_attn.launches, K.launches
        doc = json.loads(path.read_text())
    c = doc["counters"]
    done = stats["served"] + len(stats["failed"]) + len(stats["expired"])
    check(done == SERVE["requests"], f"chaos: {done} requests accounted for")
    check(c["faults_injected"] >= 2 and c["nan_retired"] == 1,
          f"chaos: counters {c}")
    check(len(doc["stragglers"]) >= 1, "chaos: no straggler step flagged")
    check(doc["pools"]["kv"]["live_at_end"] == 0
          and stats["leaked_blocks"] == 0, "chaos: blocks leaked")
    for rid, toks in stats["finished"].items():
        check(toks == plain["finished"][rid],
              f"chaos: request {rid}'s tokens differ from the plain churn's")
    check(n_pre == stats["slot_prefills"] * cfg.n_layers
          and n_dec == stats["decode_steps"] * cfg.n_layers,
          f"chaos: launches prefill {n_pre} decode {n_dec} for "
          f"{stats['slot_prefills']} prefills, {stats['decode_steps']} steps")
    print(f"[chaos] plain, plan {CHAOS}, deadline_steps "
          f"{CHAOS_DEADLINE_STEPS}: served {stats['served']}, failed "
          f"{sorted(stats['failed'])}, expired {sorted(stats['expired'])}, "
          f"{stats['tok_s']:.1f} tok/s, p50/p99 step "
          f"{stats['p50_step_ms']:.2f}/{stats['p99_step_ms']:.2f} ms, "
          f"counters {c}, stragglers "
          f"{[(r['step'], round(r['ratio'], 1)) for r in doc['stragglers']]}"
          f", finished tokens == plain, leaked {stats['leaked_blocks']}, "
          f"launches prefill {n_pre} decode {n_dec}")

    for name, draft in (("self", None), (f"self:{SPEC['prefix_layers']}",
                                         srv.make_self_draft(
                                             params, cfg,
                                             SPEC["prefix_layers"]))):
        K.verify_launches = 0
        spec = srv.serve_speculative(params, cfg, prompts, gamma=SPEC["gamma"],
                                     draft=draft, **kw)
        torch.cuda.synchronize()
        n_ver = K.verify_launches
        pools = spec["health"]["pools"]
        water = {k: (p["high_water"], p["live_at_end"])
                 for k, p in pools.items()}
        done = spec["served"] + len(spec["failed"]) + len(spec["expired"])
        what = f"chaos speculative {name}"
        check(done == SERVE["requests"], f"{what}: {done} accounted for")
        check(spec["leaked_blocks"] == 0
              and all(p["live_at_end"] == 0 for p in pools.values()),
              f"{what}: leaked {spec['leaked_blocks']} ({pools})")
        check(n_ver == spec["verify_steps"] * cfg.n_layers,
              f"{what}: verify launches {n_ver} != {spec['verify_steps']} "
              f"x {cfg.n_layers}")
        print(f"[chaos] {what} gamma {SPEC['gamma']}: served "
              f"{spec['served']}, failed {sorted(spec['failed'])}, expired "
              f"{sorted(spec['expired'])}, {spec['verify_steps']} rounds, "
              f"{spec['tok_s']:.1f} tok/s, counters "
              f"{spec['health']['counters']}, pools {water} (high water, "
              f"live at end), verify launches {n_ver}")


def sampled_phase(torch, dev, params, cfg, plain):
    """Sampled churn: the same seed gives the same tokens with a full pool
    and under preemption, another seed others, and a nucleus of one token
    the greedy tokens."""
    from repro_torch.core import paged_kv
    from repro_torch.kernels import splitmax_decode
    from repro_torch.launch import serve as srv

    prompts, gens = churn(cfg)
    kw = dict(slots=SERVE["slots"], gen=SERVE["gen"], gens=gens,
              block_k=SERVE["block_k"], **SAMPLED)
    pool = 1 + PRESSURE_POOL_SEQS * paged_kv.blocks_per_seq(
        SERVE["prompt_len"] + SERVE["gen"] + 8, SERVE["block_k"])
    splitmax_decode.launches = 0
    runs = [srv.serve_paged(params, cfg, prompts, **kw)]
    torch.cuda.synchronize()
    n_dec = splitmax_decode.launches
    check(n_dec == runs[0]["decode_steps"] * cfg.n_layers,
          f"sampled: decode launches {n_dec} != {runs[0]['decode_steps']} x "
          f"{cfg.n_layers}")
    runs.append(srv.serve_paged(params, cfg, prompts, **kw))
    runs.append(srv.serve_paged(params, cfg, prompts, pool_blocks=pool, **kw))
    other = srv.serve_paged(params, cfg, prompts,
                            **dict(kw, sample_seed=SAMPLED["sample_seed"] + 1))
    tiny = srv.serve_paged(params, cfg, prompts, **dict(kw, top_p=1e-9))
    for i, run in enumerate(runs + [other, tiny]):
        check_served(run, gens, cfg.vocab_size, f"sampled run {i}")
    check(runs[1]["finished"] == runs[0]["finished"],
          "sampled: the same seed gave other tokens")
    check(runs[2]["preemptions"] >= 1
          and runs[2]["finished"] == runs[0]["finished"],
          f"sampled under pressure ({runs[2]['preemptions']} preemptions): "
          f"tokens differ from the full pool's")
    check(other["finished"] != runs[0]["finished"],
          "sampled: another seed gave the same tokens")
    check(tiny["finished"] == plain["finished"],
          "sampled with top_p 1e-9: tokens differ from greedy")
    same = sum(runs[0]["finished"][r] == plain["finished"][r]
               for r in plain["finished"])
    print(f"[sampled] {SAMPLED}: {runs[0]['tok_s']:.1f} and "
          f"{runs[1]['tok_s']:.1f} tok/s with a full pool (plain greedy "
          f"{plain['tok_s']:.1f}), p50/p99 step {runs[0]['p50_step_ms']:.2f}/"
          f"{runs[0]['p99_step_ms']:.2f} ms; pool {pool}: "
          f"{runs[2]['preemptions']} preemptions, {runs[2]['tok_s']:.1f} "
          f"tok/s; the three runs' tokens equal, seed "
          f"{SAMPLED['sample_seed'] + 1} differs, top_p 1e-9 == greedy; "
          f"{same}/{len(plain['finished'])} sampled requests equal greedy; "
          f"decode launches {n_dec}")


# --------------------------------------------------------------- training --

def _run_steps(torch, step, params, state, dc, n, device):
    """``n`` train steps on ``device``; returns the state and the losses
    and grad norms as floats."""
    from repro_torch.data.pipeline import batch_for_step
    losses, norms = [], []
    for i in range(n):
        batch = {k: v.to(device) for k, v in batch_for_step(dc, i).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params, state, losses, norms


def fq_int8_agreement(torch, params, cfg, tokens, frames=None):
    """The reference's system check (``tests/test_system.py``): the
    teacher-forced logits of the training forward (fakequant) against the
    int8 datapath's; an encoder-decoder's forward takes its ``frames``.
    Returns (top-1 agreement, total variation, kernel-1 launches of the
    int8 forward)."""
    from repro_torch.kernels import splitmax_attn
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T

    def forward(c):
        if c.family == "encdec":
            return E.forward(params, {"frames": frames, "tokens": tokens},
                             c)[0]
        return T.forward(params, tokens, c)[0]

    with torch.no_grad():
        logits_fq = forward(cfg)
        torch.cuda.synchronize()
        splitmax_attn.launches = 0
        logits_i8 = forward(cfg.replace(attn_mode="int8"))
        torch.cuda.synchronize()
        n = splitmax_attn.launches
        p_fq = torch.softmax(logits_fq[..., :cfg.vocab_size], -1)
        p_i8 = torch.softmax(logits_i8[..., :cfg.vocab_size], -1)
        agree = float((p_fq.argmax(-1) == p_i8.argmax(-1)).float().mean())
        tv = 0.5 * float((p_fq - p_i8).abs().sum(-1).mean())
    check(bool(torch.isfinite(logits_i8).all()), "int8 forward: non-finite")
    return agree, tv, n


def train_smoke_phase(torch, dev):
    """The QAT trainer at the smoke size in f32: the card against the CPU
    over ``TRAIN_SMOKE["steps"]`` steps from the same weights and batches;
    the same step twice on the card, bit for bit (loss, every gradient,
    every parameter after the update); the CLI's resume, 6 steps straight
    against 3, a checkpoint and 3 more, bit for bit; and the
    fakequant->int8 check after 30 steps at the reference's thresholds.
    Returns the int8 forward's kernel-1 launches."""
    import tempfile
    from repro_torch import tree as tu
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import steps as st
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    t = TRAIN_SMOKE
    cfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    cpu = torch.device("cpu")
    opt = adamw.OptimizerConfig(peak_lr=1e-3, warmup_steps=2,
                                total_steps=t["steps"])
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                    global_batch=t["batch"], seed=t["seed"])
    p0 = T.init_params(cfg, seed=0, device=cpu)

    def fresh(device):
        """A copy of the initial weights on ``device`` (steps update their
        parameters in place)."""
        return tu.tree_map(lambda x: x.clone().to(device), p0)

    def run(device):
        params = fresh(device)
        return _run_steps(torch, st.make_train_step(cfg, opt), params,
                          adamw.init_state(params), dc, t["steps"],
                          device)[2:]

    (gl, gn), (cl, cn) = run(dev), run(cpu)
    check(all(map(math.isfinite, gl + gn)), f"smoke training: {gl} {gn}")
    err = max(abs(a - b) / abs(b) for a, b in zip(gl + gn, cl + cn))
    check(err <= 1e-3, f"smoke training, card vs CPU: losses {gl} vs {cl}, "
          f"grad norms {gn} vs {cn}: relative difference {err:.3g} > 1e-3")
    print(f"[train] smoke {t}: card vs CPU over {t['steps']} steps, losses "
          f"{[round(x, 5) for x in gl]}, max relative difference of the "
          f"losses and grad norms {err:.3g} (tol 1e-3)")

    outs = []
    for _ in range(2):
        params = fresh(dev)
        batch = {k: v.to(dev) for k, v in batch_for_step(dc, 0).items()}
        (loss, _), grads = st.value_and_grad(params, batch, cfg)
        params, _, m = st.make_train_step(cfg, opt)(
            params, adamw.init_state(params), batch)
        outs.append([loss, m["grad_norm"]] + tu.leaves((grads, params)))
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    check(same, "smoke training: the same step twice differs on the card")
    print(f"[train] smoke: the same step twice on the card: loss, grad norm, "
          f"{len(outs[0]) - 2} gradient and parameter leaves bit for bit")

    with tempfile.TemporaryDirectory() as tmp:
        common = ["--smoke", "--device", "cuda", "--batch", str(t["batch"]),
                  "--seq", str(t["seq"]), "--log-every", "3"]
        straight = train.main(common + ["--steps", "6", "--ckpt-dir",
                                         f"{tmp}/a"])
        first = train.main(common + ["--steps", "3", "--ckpt-dir",
                                      f"{tmp}/b"])
        second = train.main(common + ["--steps", "6", "--ckpt-dir",
                                       f"{tmp}/b"])
    check(second["start_step"] == 3, "CLI: the second run did not resume")
    check(first["losses"] + second["losses"] == straight["losses"],
          f"CLI resume: losses {first['losses']} + {second['losses']} != "
          f"{straight['losses']}")
    check(all(torch.equal(a, b) for a, b in zip(
        tu.leaves((second["params"], second["opt_state"])),
        tu.leaves((straight["params"], straight["opt_state"])))),
        "CLI resume: final parameters or moments differ from the straight run")
    print("[train] smoke CLI: 3 steps + checkpoint + resume + 3 steps == 6 "
          "steps straight: losses, parameters and moments bit for bit")

    f = FQ_INT8
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=f["seq"],
                    global_batch=f["batch"], seed=f["seed"])
    params = fresh(dev)
    params, _, losses, _ = _run_steps(
        torch, st.make_train_step(cfg, adamw.OptimizerConfig(
            peak_lr=1e-3, warmup_steps=5, total_steps=f["steps"])),
        params, adamw.init_state(params), dc, f["steps"], dev)
    tok = batch_for_step(dc, 100)["tokens"][:, :f["tokens"]].to(dev)
    agree, tv, n = fq_int8_agreement(torch, params, cfg, tok)
    check(agree > 0.9 and tv < 0.1, f"fakequant->int8 (smoke): top-1 "
          f"agreement {agree:.4f} (want > 0.9), TV {tv:.4f} (want < 0.1)")
    check(n == cfg.n_layers, f"int8 forward: {n} kernel-1 launches")
    print(f"[train] smoke fakequant->int8 after {f['steps']} steps (loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}): top-1 agreement "
          f"{agree:.4f} (> 0.9), TV {tv:.4f} (< 0.1), {n} kernel-1 launches")
    return n


def train_full_phase(torch, dev):
    """The QAT trainer at full TinyLlama-1.1B width through
    ``launch.train.main``: 8 steps of B 4 x S 2048, bf16 compute, f32
    master weights, warmup 2, seed 0; then the fakequant->int8 check of
    the trained weights at B 1 x 2048, the fakequant attention of one
    layer timed alone, and one fresh step under the profiler, whose loss
    and grad norm must repeat the run's first bit for bit.  Returns the
    int8 forward's kernel-1 launches."""
    import statistics
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tree as tu
    from repro_torch.configs import get_arch
    from repro_torch.core import attention as core_attn
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import steps as st
    from repro_torch.launch import train
    from repro_torch.launch.roofline import measured_mfu
    from repro_torch.optim import adamw

    t = TRAIN_FULL
    cfg = get_arch("tinyllama_1p1b").config
    argv = ["--device", "cuda", "--steps", str(t["steps"]), "--warmup",
            str(t["warmup"]), "--batch", str(t["batch"]), "--seq",
            str(t["seq"]), "--seed", str(t["seed"]), "--log-every", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = train.main(argv)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = res["losses"]
    check(all(map(math.isfinite, losses + res["grad_norms"])),
          f"full-width training: losses {losses}")
    check(losses[-1] < losses[0], f"full-width training: loss did not fall: "
          f"{losses}")
    tokens = t["batch"] * t["seq"]
    step_ms = statistics.median(res["step_s"][1:]) * 1e3
    n_params = sum(p.numel() for p in tu.leaves(res["params"]))
    flops = 6 * n_params * tokens
    mfu = measured_mfu(flops, step_ms / 1e3)
    print(f"[train] full width {cfg.name} {t}: losses "
          f"{[round(x, 4) for x in losses]}; step {step_ms:.1f} ms (median "
          f"of steps 2-{t['steps']}; first {res['step_s'][0] * 1e3:.1f} ms), "
          f"{tokens / step_ms * 1e3:.1f} tok/s, MFU {100 * mfu:.2f}% (6 x "
          f"{n_params} params x {tokens} tokens / step over 989 TFLOP/s "
          f"bf16), peak memory {peak_gb:.2f} GB")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=INT8_CHECK["s"],
                    global_batch=INT8_CHECK["b"], seed=t["seed"])
    tok = batch_for_step(dc, 100)["tokens"].to(dev)
    agree, tv, n_int8 = fq_int8_agreement(torch, res["params"], cfg, tok)
    check(n_int8 == cfg.n_layers, f"full-width int8 forward: {n_int8} "
          f"kernel-1 launches, want {cfg.n_layers}")
    print(f"[train] full-width fakequant->int8 after {t['steps']} steps, "
          f"B {INT8_CHECK['b']} x {INT8_CHECK['s']}: top-1 agreement "
          f"{agree:.4f}, TV {tv:.4f}, {n_int8} kernel-1 launches")
    first = (losses[0], res["grad_norms"][0])
    del res
    torch.cuda.empty_cache()

    # one layer's fakequant attention alone: the layer's first forward (no
    # graph: the block is checkpointed), then its recompute and backward
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s, hd = t["batch"], t["seq"], cfg.hd
    q = torch.randn((b, cfg.n_heads, s, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16).requires_grad_(True)
    k, v = (torch.randn((b, cfg.n_kv_heads, s, hd), generator=gen,
                        device=dev, dtype=torch.bfloat16).requires_grad_(True)
            for _ in range(2))
    g = torch.randn(q.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    spec = cfg.attn_spec()

    def fwd():
        with torch.no_grad():
            core_attn.attention(q, k, v, spec)

    def fwd_bwd():
        core_attn.attention(q, k, v, spec).backward(g)

    attn_ms = time_ms(torch, fwd, iters=3, warm=1) + time_ms(
        torch, fwd_bwd, iters=3, warm=1)
    share = cfg.n_layers * attn_ms / step_ms
    print(f"[train] fakequant attention of one layer (B {b}, Hq "
          f"{cfg.n_heads}, Hkv {cfg.n_kv_heads}, S {s}, D {hd}, block_k "
          f"{core_attn.FAKEQUANT_BLOCK_K}): forward + recompute + backward "
          f"{attn_ms:.2f} ms; x {cfg.n_layers} layers = {100 * share:.1f}% "
          f"of the step")
    del q, k, v, g
    torch.cuda.empty_cache()

    params = st.init_params_fn(cfg)(seed=t["seed"], device=dev)
    state = adamw.init_state(params)
    step = st.make_train_step(cfg, adamw.OptimizerConfig(
        peak_lr=3e-4, warmup_steps=t["warmup"], total_steps=t["steps"]))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                    global_batch=t["batch"], seed=t["seed"])
    batch = {k: v.to(dev) for k, v in batch_for_step(dc, 0).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        again = (float(m["loss"]), float(m["grad_norm"]))
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(again == first, f"full width: the first step's (loss, grad norm) "
          f"{again} != the run's {first}")
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in rows)
    check(busy_ms > 0, "profiler saw no device time")
    rows.sort(key=lambda r: -r[2])
    print(f"[train] first step again under the profiler: (loss, grad norm) "
          f"{again} bit for bit the run's; wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for key, count, ms in rows[:12]:
        print(f"[train]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  "
              f"x{count:<6d} {key[:90]}")
    del params, state, batch
    torch.cuda.empty_cache()
    return n_int8


def int8_attention_calls(cfg) -> int:
    """Kernel-1 launches of one int8 training forward: one an attention
    layer; the hybrid's shared block once every ``hybrid_attn_every``
    layers; an encoder-decoder's encoder self, decoder self and cross."""
    if cfg.family == "encdec":
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def ulp_perturbed(torch, tree, rng):
    """``tree`` (nested dicts and lists of tensors) with every f32 element
    moved one ulp up or down, a fair coin each (numpy ``rng``)."""
    import numpy as np
    if isinstance(tree, dict):
        return {k: ulp_perturbed(torch, v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(ulp_perturbed(torch, v, rng) for v in tree)
    if not (isinstance(tree, torch.Tensor) and tree.dtype == torch.float32):
        return tree
    a = tree.detach().cpu().numpy()
    up = rng.integers(0, 2, a.shape, dtype=bool)
    moved = np.nextafter(a, np.where(up, np.float32(np.inf),
                                     np.float32(-np.inf)))
    return torch.from_numpy(moved).to(tree.device)


def fq_edge_record(torch, cfg, params, batch, dev) -> str:
    """The first score whose fakequant grid index differs between the card
    and the CPU in one forward from the same weights and batch: its call,
    element, the quotients z / s_z on both and their distance in ulps from
    the .5 edge between them; or that none differs."""
    import numpy as np
    from repro_torch import tree as tu
    from repro_torch.core import quantization as qlib
    from repro_torch.launch import steps as st
    seen = {}
    orig = qlib.fake_quant

    def hook(where):
        def fq(x, scale):
            seen.setdefault(where, []).append(
                (x.detach().float().cpu().numpy(),
                 float(scale.detach().cpu())))
            return orig(x, scale)
        return fq
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        qlib.fake_quant = hook(where)
        try:
            with torch.no_grad():
                st.loss_fn(tu.tree_map(lambda x: x.to(device), params),
                           {k: v.to(device) for k, v in batch.items()}, cfg)
        finally:
            qlib.fake_quant = orig
    for i, ((zc, s_z), (zh, _)) in enumerate(zip(seen["card"], seen["cpu"])):
        rc = (zc / np.float32(s_z)).astype(np.float32)
        rh = (zh / np.float32(s_z)).astype(np.float32)
        flips = np.argwhere(np.round(rc) != np.round(rh))
        if len(flips):
            idx = tuple(int(x) for x in flips[0])
            edge = np.float32(np.floor(min(rc[idx], rh[idx])) + 0.5)
            ulp = float(np.spacing(edge))
            return (f"call {i} of {len(seen['card'])}, element {idx}: z / s_z "
                    f"card {float(rc[idx])!r} ({(rc[idx] - edge) / ulp:+.0f} "
                    f"ulp from the edge {float(edge)}), CPU "
                    f"{float(rh[idx])!r} ({(rh[idx] - edge) / ulp:+.0f} ulp); "
                    f"{int((zc != zh).sum())} of {zc.size} scores of that call "
                    f"differ in some bit")
    return (f"no score's grid index differs over {len(seen['card'])} "
            f"fakequant calls")


def family_smoke_train(torch, dev, arch: str) -> int:
    """Phase 14 on one smoke config in f32: the card against the CPU over
    ``TRAIN_SMOKE["steps"]`` steps (losses and grad norms within 1e-3);
    the same step twice on the card, bit for bit; the CLI's resume, 6
    steps straight against 3, a checkpoint and 3 more, bit for bit; and,
    where the family has attention, the fakequant->int8 agreement after
    ``FQ_INT8["steps"]`` steps, a record (its 0.9 / 0.1 gate is the dense
    family's).  Returns the int8 forward's kernel-1 launches."""
    import tempfile
    from repro_torch import tree as tu
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import steps as st
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    t = TRAIN_SMOKE
    cfg = get_arch(arch).smoke.replace(dtype="float32")
    cpu = torch.device("cpu")
    opt = adamw.OptimizerConfig(peak_lr=1e-3, warmup_steps=2,
                                total_steps=t["steps"])

    def data(seq, batch, seed):
        return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=seed,
                          frames=cfg.family == "encdec", d_model=cfg.d_model)

    dc = data(t["seq"], t["batch"], t["seed"])
    p0 = st.init_params_fn(cfg)(seed=0, device=cpu)

    def fresh(device):
        """A copy of the initial weights on ``device`` (steps update their
        parameters in place)."""
        return tu.tree_map(lambda x: x.clone().to(device), p0)

    def run(device, c=cfg):
        params = fresh(device)
        return _run_steps(torch, st.make_train_step(c, opt), params,
                          adamw.init_state(params), dc, t["steps"],
                          device)[2:]

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    import numpy as np
    drawn = []

    def cpu_draws():
        """The CPU's grad norms over the steps from the initial weights moved
        by +-1 ulp, one list a draw."""
        if not drawn:
            rng = np.random.default_rng(0)
            for _ in range(FAMILY_ULP_DRAWS):
                params = ulp_perturbed(torch, p0, rng)
                drawn.append(_run_steps(
                    torch, st.make_train_step(cfg, opt), params,
                    adamw.init_state(params), dc, t["steps"], cpu)[3])
        return drawn

    # the first step's gradients leaf by leaf, then the steps with float
    # attention (no int8 rounding edge to cross) and as trained (fakequant)
    batch = batch_for_step(dc, 0)
    (gloss, _), ggrad = st.value_and_grad(
        fresh(dev), {k: v.to(dev) for k, v in batch.items()}, cfg)
    (closs, _), cgrad = st.value_and_grad(fresh(cpu), batch, cfg)
    leaf_err, leaf = max(
        (float((a.cpu() - b).abs().max() / b.abs().max()), tu.keystr(path))
        for (path, a), b in zip(tu.leaves_with_path(ggrad), tu.leaves(cgrad))
        if float(b.abs().max()) > 0)
    (fl, fn), (fcl, fcn) = (run(d, cfg.replace(attn_mode="float"))
                            for d in (dev, cpu))
    (gl, gn), (cl, cn) = run(dev), run(cpu)
    check(all(map(math.isfinite, gl + gn)), f"{arch} smoke training: {gl}")
    err = rel(gl + gn, cl + cn)
    print(f"[train-families] {arch} smoke, card vs CPU: the first step's "
          f"loss {rel([float(gloss)], [float(closs)]):.3g}, gradient leaves "
          f"within {leaf_err:.3g} of their scale (worst {leaf}); "
          f"{t['steps']} steps, relative differences by step: losses "
          f"{[float(f'{abs(a - b) / abs(b):.3g}') for a, b in zip(gl, cl)]}, "
          f"grad norms "
          f"{[float(f'{abs(a - b) / abs(b):.3g}') for a, b in zip(gn, cn)]}; "
          f"with float attention: losses {rel(fl, fcl):.3g}, grad norms "
          f"{rel(fn, fcn):.3g}")
    tol = FAMILY_CARD_TOL
    float_err = rel(fl + fn, fcl + fcn)
    check(float_err <= tol["float"], f"{arch} smoke training with float "
          f"attention, card vs CPU: losses {fl} vs {fcl}, grad norms {fn} vs "
          f"{fcn}: relative difference {float_err:.3g}")
    check(rel(gl, cl) <= tol["loss"], f"{arch} smoke training, card vs "
          f"CPU: losses {gl} vs {cl}: relative difference {rel(gl, cl):.3g}")
    check(leaf_err <= tol["grad_leaf"], f"{arch} smoke training, card vs "
          f"CPU: the first step's gradient leaves within {leaf_err:.3g} of "
          f"their scale (worst {leaf})")
    # grad norms: within the bound of the CPU's, or past it only where a CPU
    # draw on inputs moved by one ulp moves the CPU's at least as far
    gb = tol["grad_norm"]
    past = [i for i in range(len(gn)) if abs(gn[i] - cn[i]) > gb * abs(cn[i])]
    for i in past:
        far = max(abs(ns[i] - cn[i]) for ns in cpu_draws())
        near = min(abs(gn[i] - ns[i]) for ns in cpu_draws())
        print(f"[train-families] {arch} smoke: step {i + 1}'s grad norm past "
              f"{gb} card vs CPU: card {gn[i]!r}, CPU {cn[i]!r}, card - CPU "
              f"{gn[i] - cn[i]:.6g}; over {FAMILY_ULP_DRAWS} one-ulp CPU "
              f"draws {sorted(ns[i] for ns in drawn)}: the farthest moves "
              f"{far:.6g} (at least as far: {far >= abs(gn[i] - cn[i])}), the "
              f"nearest lies {near:.6g} from the card's (within the bound "
              f"{gb * abs(gn[i]):.6g}: {near <= gb * abs(gn[i])})")
    bad = [i for i in past
           if not any(abs(ns[i] - cn[i]) >= abs(gn[i] - cn[i])
                      for ns in cpu_draws())]
    check(not bad, f"{arch} smoke training, card vs CPU: grad norms {gn} "
          f"vs {cn}: steps {bad} past {gb} and farther than every CPU "
          f"one-ulp draw {[[round(x, 6) for x in ns] for ns in drawn]}")
    if cfg.family != "ssm":
        print(f"[train-families] {arch} smoke, the first fakequant edge card "
              f"vs CPU in the first forward: "
              f"{fq_edge_record(torch, cfg, p0, batch, dev)}")

    outs = []
    for _ in range(2):
        params = fresh(dev)
        batch = {k: v.to(dev) for k, v in batch_for_step(dc, 0).items()}
        (loss, _), grads = st.value_and_grad(params, batch, cfg)
        params, _, m = st.make_train_step(cfg, opt)(
            params, adamw.init_state(params), batch)
        outs.append([loss, m["grad_norm"]] + tu.leaves((grads, params)))
    check(all(torch.equal(a, b) for a, b in zip(*outs)),
          f"{arch} smoke training: the same step twice differs on the card")

    with tempfile.TemporaryDirectory() as tmp:
        common = ["--arch", arch, "--smoke", "--device", "cuda", "--batch",
                  str(t["batch"]), "--seq", str(t["seq"]), "--log-every", "3"]
        straight = train.main(common + ["--steps", "6", "--ckpt-dir",
                                         f"{tmp}/a"])
        first = train.main(common + ["--steps", "3", "--ckpt-dir",
                                      f"{tmp}/b"])
        second = train.main(common + ["--steps", "6", "--ckpt-dir",
                                       f"{tmp}/b"])
    check(second["start_step"] == 3, f"{arch} CLI: the second run did not "
          f"resume")
    check(first["losses"] + second["losses"] == straight["losses"],
          f"{arch} CLI resume: losses {first['losses']} + "
          f"{second['losses']} != {straight['losses']}")
    check(all(torch.equal(a, b) for a, b in zip(
        tu.leaves((second["params"], second["opt_state"])),
        tu.leaves((straight["params"], straight["opt_state"])))),
        f"{arch} CLI resume: final parameters or moments differ from the "
        f"straight run")
    line = (f"[train-families] {arch} smoke ({cfg.family}): card vs CPU over "
            f"{t['steps']} steps, losses {[round(x, 5) for x in gl]}, max "
            f"relative difference of the losses and grad norms {err:.3g} "
            f"(tol {tol['loss']} / {tol['grad_norm']}; float attention "
            f"{float_err:.3g}, tol {tol['float']}); the same step twice on "
            f"the card bit for bit (loss, "
            f"grad norm, {len(outs[0]) - 2} gradient and parameter leaves); "
            f"CLI 3 steps + checkpoint + resume + 3 == 6 straight, bit for "
            f"bit")
    n = 0
    if cfg.family != "ssm":
        f = FQ_INT8
        dc = data(f["seq"], f["batch"], f["seed"])
        params = fresh(dev)
        params, _, losses, _ = _run_steps(
            torch, st.make_train_step(cfg, adamw.OptimizerConfig(
                peak_lr=1e-3, warmup_steps=5, total_steps=f["steps"])),
            params, adamw.init_state(params), dc, f["steps"], dev)
        batch = batch_for_step(dc, 100)
        tok = batch["tokens"][:, :f["tokens"]].to(dev)
        frames = (batch["frames"][:, :f["tokens"]].to(dev)
                  if "frames" in batch else None)
        agree, tv, n = fq_int8_agreement(torch, params, cfg, tok, frames)
        want = int8_attention_calls(cfg)
        check(n == want, f"{arch} int8 forward: {n} kernel-1 launches, "
              f"want {want}")
        line += (f"; fakequant->int8 after {f['steps']} steps (loss "
                 f"{losses[0]:.4f} -> {losses[-1]:.4f}): top-1 agreement "
                 f"{agree:.4f}, TV {tv:.4f} (a record; the gate is the dense "
                 f"family's), {n} kernel-1 launches")
    print(line)
    return n


def train_with_peak(torch, argv):
    """``launch.train.main(argv)`` and the card's peak memory over it."""
    import gc
    from repro_torch.launch import train
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = train.main(argv)
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated()


def families_full_phase(torch, dev) -> None:
    """Phase 14 at full width: each of ``FAMILY_FULL`` through
    ``launch.train.main`` for ``FAMILY_TRAIN["steps"]`` steps of bf16
    compute over f32 masters.  Prints step ms (median of steps 2 on),
    tok/s, MFU (6 x params x tokens over 989 TFLOP/s; a MoE config's
    active parameters), peak memory, and whether the loss is finite and
    falls, with each cut.  Falcon-Mamba's batch, then its depth, come from
    one layer's step peak at B 1, measured first (the Mamba-1 scan's
    backward keeps every level of its recursion)."""
    import gc
    import statistics
    from repro_torch import tree as tu
    from repro_torch.configs import get_arch
    from repro_torch.launch.roofline import measured_mfu

    ft = FAMILY_TRAIN
    total = torch.cuda.get_device_properties(0).total_memory
    for arch, layers in FAMILY_FULL:
        full = get_arch(arch).config
        cfg = full.replace(n_layers=layers) if layers else full
        common = ["--arch", arch, "--device", "cuda", "--warmup",
                  str(ft["warmup"]), "--seq", str(ft["seq"]), "--seed",
                  str(ft["seed"]), "--log-every", "100"]
        base = common + (["--layers", str(layers)] if layers else [])
        batch, plan = ft["batch"], "as planned"
        if cfg.family == "ssm":
            # one layer's step peak at B 1 sizes the batch: the scan's
            # backward keeps every level of the recursion a chunk
            res, peak1 = train_with_peak(torch, common + [
                "--layers", "1", "--steps", "1", "--batch", "1"])
            state1 = 16 * sum(p.numel() for p in tu.leaves(res["params"]))
            del res
            act = peak1 - state1

            def predicted(n_layers, b):
                """f32 masters, gradients and moments of ``n_layers``
                layers, and ``b`` times one layer's activations at B 1."""
                return 16 * full.replace(n_layers=n_layers).param_count() \
                    + b * act

            # the first batch from ``batch`` down that fits at the starting
            # depth, then the deepest config that fits at that batch, with
            # a fifth of the card kept for what the estimate misses
            batch = next((b for b in (batch, 2, 1)
                          if predicted(layers, b) <= 0.8 * total), 1)
            layers = max(n for n in range(layers, full.n_layers + 1)
                         if predicted(n, batch) <= 0.8 * total) \
                if predicted(layers, batch) <= 0.8 * total else layers
            cfg = full.replace(n_layers=layers)
            base = common + ["--layers", str(layers)]
            plan = (f"one layer at B 1: step peak {peak1 / 1e9:.2f} GB, "
                    f"state {state1 / 1e9:.2f} GB; predicted at {layers} "
                    f"layers B {batch}: {predicted(layers, batch) / 1e9:.2f} "
                    f"GB of {total / 1e9:.1f}")
        t0 = time.perf_counter()
        res, peak = train_with_peak(torch, base + [
            "--steps", str(ft["steps"]), "--batch", str(batch)])
        wall = time.perf_counter() - t0
        losses = res["losses"]
        finite = all(map(math.isfinite, losses + res["grad_norms"]))
        check(finite, f"{arch} full-width training: losses {losses}")
        n_params = sum(p.numel() for p in tu.leaves(res["params"]))
        n_model = (cfg.active_param_count() if cfg.family == "moe"
                   else n_params)
        tokens = batch * ft["seq"]
        step_ms = statistics.median(res["step_s"][1:]) * 1e3
        mfu = measured_mfu(6 * n_model * tokens, step_ms / 1e3)
        cuts = []
        if layers and layers < full.n_layers:
            cuts.append(f"depth {layers} of {full.n_layers} layers")
        if batch < ft["batch"]:
            cuts.append(f"batch {batch} of {ft['batch']}")
        print(f"[train-families] {arch} full width (d_model {cfg.d_model}, "
              f"{cfg.n_layers} layers{', ' if cuts else ''}"
              f"{'; '.join(cuts) or ', no cut'}; {plan}): B {batch} x "
              f"{ft['seq']}, {ft['steps']} steps, losses "
              f"{[round(x, 4) for x in losses]}, finite {finite}, falling "
              f"{losses[-1] < losses[0]}; step {step_ms:.1f} ms (median of "
              f"steps 2-{ft['steps']}; first {res['step_s'][0] * 1e3:.1f} "
              f"ms), {tokens / step_ms * 1e3:.1f} tok/s, MFU {100 * mfu:.2f}% "
              f"(6 x {n_model} {'active ' if cfg.family == 'moe' else ''}"
              f"params x {tokens} tokens over 989 TFLOP/s bf16), peak "
              f"memory {peak / 1e9:.2f} GB, {n_params} parameters; "
              f"{wall:.1f} s")
        del res
        gc.collect()
        torch.cuda.empty_cache()


def verify_equals_decode(torch, dev, params, cfg, b: int, t: int) -> None:
    """``verify_step``'s logits for T tokens of B slots against T
    ``decode_step`` calls on a copy of the same paged cache (16-token
    prompts prefilled slot by slot): equal bit for bit, as speculative
    tokens equal plain ones only if they are."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    if cfg.family == "moe" and MOE._capacity(cfg.moe, t) < t:
        # the verify's T tokens share one capacity group, as the
        # reference's: past the capacity it drops what decode keeps
        print(f"[rows] {cfg.name}: verify's logits not held against "
              f"decode's: {t} tokens over a capacity of "
              f"{MOE._capacity(cfg.moe, t)} (ROADMAP queue 3, the "
              f"reference's)")
        return
    gen = torch.Generator(device="cpu").manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (b, 16), generator=gen,
                            dtype=torch.int32).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                           dtype=torch.int32).to(dev)
    cache = T.make_paged_cache(cfg, b, 16 + t, block_k=SERVE["block_k"],
                               device=dev)
    bps = cache["block_table"].shape[1]
    rows = torch.arange(1, 1 + b * bps, dtype=torch.int32,
                        device=dev).reshape(b, bps)
    with torch.no_grad():
        for slot in range(b):
            T.prefill_paged(params, prompts[slot:slot + 1], cfg, cache,
                            torch.tensor([slot], dtype=torch.int32,
                                         device=dev),
                            rows[slot:slot + 1], calibrate=slot == 0)
        seq = {k: v.clone() for k, v in cache.items()}
        logits, _ = T.verify_step(params, tokens, cfg, cache)
        same = []
        for i in range(t):
            step, seq = T.decode_step(params, tokens[:, i].contiguous(), cfg,
                                      seq)
            same.append(torch.equal(logits[:, i], step))
    check(all(same), f"{cfg.name}: verify_step's logits differ from "
          f"decode_step's at tokens {[i for i, x in enumerate(same) if not x]}")
    print(f"[rows] {cfg.name}: verify_step's logits for {t} tokens x {b} "
          f"slots == {t} decode_step calls', bit for bit")


def rows_agree(torch, dev, params, cfg, b: int, t: int) -> bool:
    """Whether a row's result depends on the number of rows it is computed
    with: decode runs B rows, verify B * T.  For each linear weight of the
    first layer of each kind in the compute dtype, ``x[:B] @ W`` against
    the first B rows of ``x @ W`` at M = B * T, a record: verify runs every
    float stage that reduces along a row one token at a time, at the
    decode step's shape (the norms, the q/k norms, the attention
    projections, the MLP, the MoE router and shared experts and the f32 LM
    head, a tied config's the f32 embedding table as
    ``layers.unembed_apply`` multiplies it).  (The expert GEMMs have the
    same shape in both: their rows are the capacity slots.)  The norms'
    lines (RMSNorm; the q/k RMSNorm over each head's D; OLMo's
    non-parametric LayerNorm) are shown for every config.  Then
    :func:`verify_equals_decode` holds the logits; returns True when it
    passed (it fails the run otherwise)."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(6)
    embed = params["embed"]
    # weights as the serve step multiplies them, an int8 one dequantized
    # when its turn comes (a tied int8 table: its payload, the scale
    # multiplies the logits after the product)
    head = (("tied head (embedding table)",
             lambda: embed.get("table", embed.get("table_q")).T)
            if cfg.tie_embeddings else
            ("lm_head", lambda: L.linear_weight(params["lm_head"])))
    per_token, seen = [head], set()

    def linear(p):
        return lambda: L.linear_weight(p)

    for i, lp in enumerate(params["layers"]):
        kind = "moe" if "moe" in lp else "dense"
        if kind in seen:
            continue
        seen.add(kind)
        per_token += [(f"layer {i} {n}", linear(lp["attn"][n]))
                      for n in ("wq", "wk", "wv", "wo")]
        if kind == "moe":
            per_token.append((f"layer {i} router",
                              linear(lp["moe"]["router"])))
        ffn = lp["mlp"] if kind == "dense" else lp["moe"].get("shared")
        if ffn is not None:
            tag = "mlp" if kind == "dense" else "shared"
            per_token += [(f"layer {i} {tag} {n}", linear(ffn[n]))
                          for n in ("w_in", "w_gate", "w_out")]
    for name, weight in per_token:
        w = weight().to(torch.float32 if "head" in name or "router" in name
                        else cfg.compute_dtype)
        x = torch.randn((b * t, w.shape[0]), generator=gen, device=dev
                        ).to(w.dtype)
        small, big = x[:b] @ w, (x @ w)[:b]
        same = torch.equal(small, big)
        print(f"[rows] {name} {tuple(w.shape)} {w.dtype}: rows at M={b} "
              f"{'==' if same else '!='} rows at M={b * t} (max diff "
              f"{float((small.float() - big.float()).abs().max()):.3g}); "
              f"verify runs it per token")
    # the RMSNorm's f32 mean of squares, per token slice vs all tokens
    x = torch.randn((b, t, cfg.d_model), generator=gen, device=dev)
    small = torch.cat([torch.mean(torch.square(x[:, i:i + 1].contiguous()),
                                  dim=-1) for i in range(t)], dim=1)
    big = torch.mean(torch.square(x), dim=-1)
    print(f"[rows] rmsnorm mean of squares: ({b}, 1, {cfg.d_model}) slices "
          f"{'==' if torch.equal(small, big) else '!='} ({b}, {t}, "
          f"{cfg.d_model}) ({int((small != big).sum())} of {b * t} rows "
          f"differ); verify runs the norms per token")
    # the norms as the serving path applies them, on its compute dtype: the
    # q/k RMSNorm on (B, T, Hq, D) heads and the non-parametric LayerNorm on
    # (B, T, d_model) rows, per token slice vs all tokens at once
    for what, shape, fn in (
            ("q/k rmsnorm", (b, t, cfg.n_heads, cfg.hd),
             lambda y: L.rmsnorm_apply(
                 {"scale": torch.ones(cfg.hd, device=dev)}, y)),
            ("nonparam layernorm", (b, t, cfg.d_model),
             lambda y: L.nonparam_layernorm_apply({}, y))):
        x = torch.randn(shape, generator=gen, device=dev).to(
            cfg.compute_dtype)
        small, big = L.per_token(fn, x), fn(x)
        n_rows = small.numel() // shape[-1]
        differ = int((small != big).any(-1).sum())
        print(f"[rows] {what} {tuple(shape)} {x.dtype}: per-token slices "
              f"{'==' if torch.equal(small, big) else '!='} all tokens "
              f"({differ} of {n_rows} rows differ); verify runs it per "
              f"token")
    verify_equals_decode(torch, dev, params, cfg, b, t)
    return True


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


def dense_serve_phase(torch, dev, params, cfg):
    """The churn through ``serve_dense`` in turns with ``serve_paged``
    (dense, paged, dense), then its first 8 requests through the composed
    and the fused dense decode.  Returns each dense kernel's launches in
    the first dense run (the composed one's in the composed run)."""
    from repro_torch.kernels import splitmax_attn, splitmax_decode as K
    from repro_torch.launch import serve as srv

    prompts, gens = churn(cfg)
    kw = dict(slots=SERVE["slots"], gen=SERVE["gen"], gens=gens)
    # warm-up: the re-prefill's batch-wide GEMM shapes
    srv.serve_dense(params, cfg, prompts[:SERVE["slots"]],
                    slots=SERVE["slots"], gen=4,
                    gens=[2 + i % 3 for i in range(SERVE["slots"])])
    torch.cuda.synchronize()

    def dense_run(c, reqs, what):
        splitmax_attn.launches = 0
        K.launches = K.dense_launches = K.dense_composed_launches = 0
        stats = srv.serve_dense(params, c, prompts[:reqs], slots=kw["slots"],
                                gen=kw["gen"], gens=gens[:reqs])
        torch.cuda.synchronize()
        n = (splitmax_attn.launches, K.dense_launches,
             K.dense_composed_launches, K.launches)
        check_served(stats, gens[:reqs], cfg.vocab_size, what, overshoot=1)
        n_dec = n[1] if c.attn_fused else n[2]
        check(n[0] == stats["batch_prefills"] * cfg.n_layers,
              f"{what}: prefill launches {n[0]} != {stats['batch_prefills']} "
              f"batch prefills x {cfg.n_layers}")
        check(n_dec == stats["decode_steps"] * cfg.n_layers
              and n[1] + n[2] == n_dec and n[3] == 0,
              f"{what}: dense decode launches {n[1:3]} (paged {n[3]}) != "
              f"{stats['decode_steps']} steps x {cfg.n_layers}")
        print(f"[dense-serve] {what}: served {stats['served']}, "
              f"{stats['total_tokens']} tokens in {stats['wall_s']:.3f} s, "
              f"{stats['tok_s']:.1f} tok/s, {stats['decode_steps']} decode "
              f"steps, {stats['batch_prefills']} batch prefills, p50/p99 step "
              f"{stats['p50_step_ms']:.2f}/{stats['p99_step_ms']:.2f} ms, "
              f"launches prefill {n[0]} dense decode {n_dec}")
        return stats, n

    n_req = SERVE["requests"]
    dense1, n1 = dense_run(cfg, n_req, "churn dense 1")
    paged = srv.serve_paged(params, cfg, prompts, block_k=SERVE["block_k"],
                            **kw)
    torch.cuda.synchronize()
    check_served(paged, gens, cfg.vocab_size, "churn paged (between dense)")
    dense2, _ = dense_run(cfg, n_req, "churn dense 2")
    check(dense2["finished"] == dense1["finished"],
          "dense churn: the two runs' tokens differ")
    dense_tok_s = (dense1["tok_s"] + dense2["tok_s"]) / 2
    print(f"[dense-serve] paged {paged['tok_s']:.1f} tok/s (p50/p99 step "
          f"{paged['p50_step_ms']:.2f}/{paged['p99_step_ms']:.2f} ms) between "
          f"dense {dense1['tok_s']:.1f} and {dense2['tok_s']:.1f} tok/s: "
          f"paged_over_dense_tok_s {paged['tok_s'] / dense_tok_s:.3f}")

    comp, nc = dense_run(cfg.replace(attn_fused=False), COMPOSED_REQUESTS,
                         "first 8 composed")
    fused, _ = dense_run(cfg, COMPOSED_REQUESTS, "first 8 fused")
    check(comp["finished"] == fused["finished"],
          "dense composed serving tokens differ from fused serving")
    print("[dense-serve] composed tokens == fused tokens")
    return {"splitmax_attention": n1[0], "splitmax_decode_fused": n1[1],
            "splitmax_decode": nc[2]}


# ------------------------------------------------------------------- MoE --

def smoke_arch_check(torch, dev, arch: str, tag: str) -> None:
    """One smoke config in f32, kernels on the card vs plain versions on
    the CPU, same weights: paged prefill logits and 8 decode steps within
    2e-3 of the logits' scale, and the served tokens of a small churn
    (24-token prompts, up to 16 generated: past a 32-position window)
    equal."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    cfg = get_arch(arch).smoke.replace(dtype="float32")
    params = T.init_params(cfg, seed=0, device=cpu)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 20))
    gpu = smoke_paged_logits(torch, params, cfg, tokens, dev)
    ref = smoke_paged_logits(torch, params, cfg, tokens, cpu)
    err = float((gpu - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(gpu).all()), f"{arch} smoke: non-finite")
    check(err <= 2e-3 * scale, f"{arch} smoke: max|gpu-cpu| logits "
          f"{err:.3g} > 2e-3 * {scale:.3g}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 24, dtype=np.int32)
               for _ in range(6)]
    gens = [int(g) for g in rng.integers(8, 17, 6)]
    kw = dict(slots=3, gen=16, gens=gens, block_k=8)
    on_card = srv.serve_paged(tree_to(params, dev), cfg, prompts, **kw)
    on_cpu = srv.serve_paged(params, cfg, prompts, **kw)
    check_served(on_card, gens, cfg.vocab_size, f"{arch} smoke churn")
    check(on_card["finished"] == on_cpu["finished"],
          f"{arch} smoke churn: card tokens differ from the CPU's")
    print(f"[{tag}] {arch} smoke (f32), card vs CPU plain path: "
          f"prefill + 8 decode steps max|logit diff| {err:.3g} (logits "
          f"up to {scale:.3g}; tol 2e-3 of that); 6-request churn "
          f"tokens == CPU tokens")


def moe_smoke_phase(torch, dev):
    """Both MoE smoke configs (DeepSeekMoE: 1 dense layer, then MoE with
    shared experts; Mixtral: GQA, window 32): :func:`smoke_arch_check`."""
    for arch in MOE_SMOKE_ARCHS:
        smoke_arch_check(torch, dev, arch, "moe-smoke")


def moe_layer_check(torch, params, cfg, prompt):
    """Layer 1 (the first MoE layer) of the bf16 serving path against an
    f32 recomputation of the same ``moe_apply`` on the card from the same
    weights, on the hidden states of one admitted prompt (its serve-mode
    forward, the layer's input captured): routing indices equal for every
    token whose k-th and (k+1)-th probabilities are more than ``MOE_TIE``
    apart, queue positions and the dropped set equal up to the first token
    within it, and the output within the stated bf16 tolerance."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    captured = []
    apply = MOE.moe_apply

    def capture(p, x, c, **kw):
        if not captured:
            captured.append(x)
        return apply(p, x, c, **kw)

    MOE.moe_apply = capture
    try:
        T.forward(params, torch.as_tensor(prompt[None], device=params[
            "embed"]["table"].device), cfg, serve=True)
    finally:
        MOE.moe_apply = apply
    h = captured[0]                                         # (1, S, d) bf16
    layer = params["layers"][cfg.moe.first_dense_layers]["moe"]
    c32 = cfg.replace(dtype="float32")
    mc = cfg.moe
    *_, idx = MOE.route(layer, h, cfg)
    _, probs32, _, idx32 = MOE.route(layer, h.float(), c32)
    top = torch.topk(probs32, mc.top_k + 1, dim=-1).values
    tie = (top[..., -2] - top[..., -1] <= MOE_TIE)[0]
    n_tie = int(tie.sum())
    check(n_tie <= 0.01 * tie.numel(), f"moe layer: {n_tie} near-tie tokens")
    ok = ~tie
    check(torch.equal(idx[0][ok], idx32[0][ok]), "moe layer: routing indices "
          "differ between bf16 and f32")
    # queue positions cascade: compare up to the first near-tie token
    first = int(tie.nonzero()[0]) if n_tie else h.shape[1]
    cap = MOE._capacity(mc, h.shape[1])
    pos = MOE.queue_positions(idx, mc.n_experts)[:, :first]
    pos32 = MOE.queue_positions(idx32, mc.n_experts)[:, :first]
    check(torch.equal(pos, pos32), "moe layer: queue positions differ")
    dropped = int((pos >= cap).sum())
    out, _ = MOE.moe_apply(layer, h, cfg, losses=False)
    ref, _ = MOE.moe_apply(layer, h.float(), c32, losses=False)
    diff = (out.float() - ref)[:, :first]
    ref = ref[:, :first]
    err, scale = float(diff.abs().max()), float(ref.abs().max())
    rel_rms = float(diff.square().mean().sqrt() / ref.square().mean().sqrt())
    check(bool(torch.isfinite(out).all()), "moe layer: non-finite output")
    # bf16's unit roundoff u = 2^-8: the serving path rounds the expert
    # GEMMs' outputs, the SwiGLU product, the down projection's output,
    # the gate weights and the combined sum, each <= u relative, and they
    # add like a random walk: the rms error stays under 2u = 2^-7 of the
    # output's rms and every element under 8u = 2^-5 of its largest value
    check(err <= MOE_TOL_MAX * scale and rel_rms <= MOE_TOL_RMS,
          f"moe layer: bf16 vs f32 max|diff| {err:.3g} (> {MOE_TOL_MAX} * "
          f"{scale:.3g}?) rms {rel_rms:.3g} (> {MOE_TOL_RMS}?)")
    print(f"[moe] layer {cfg.moe.first_dense_layers} on a {h.shape[1]}-token "
          f"prompt, bf16 serving path vs f32 recomputation on the card: "
          f"routing equal ({n_tie} near-tie tokens within {MOE_TIE} left "
          f"out), capacity {cap}, {dropped} dropped assignments in both, "
          f"max|diff| {err:.3g} of {scale:.3g} ({err / scale:.3g}; tol "
          f"{MOE_TOL_MAX}), rms {rel_rms:.3g} (tol {MOE_TOL_RMS})")


def moe_phase(torch, dev):
    """DeepSeekMoE-16B at full width on the card, drawn leaf by leaf in
    bf16 (router and LM head f32): the churn through ``serve_paged`` with
    its warm-up, one batch under the profiler, the row-count check, the
    churn through ``serve_speculative`` self-drafted at gamma 4 (tokens
    those of the plain churn), and the layer check.  Returns the main
    paths' launches of kernels 1, 2 and 3."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import splitmax_attn, splitmax_decode as K
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(MOE_ARCH).config
    mc = cfg.moe
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SERVE["seed"], device=dev, serving=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = sum(x.numel() * x.element_size()
                  for x in tree_leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    # the f32 masters (65.5 GB) are never all on the card: at most one f32
    # leaf (the largest, the 0.84 GB embedding draw) beside the weights
    check(init_peak <= w_bytes + 2 ** 30, f"moe init: peak "
          f"{init_peak / 1e9:.2f} GB for {w_bytes / 1e9:.2f} GB of weights")
    print(f"[moe] {cfg.name} at full width: {cfg.n_layers} layers "
          f"({mc.first_dense_layers} dense, then MoE), d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
          f"{mc.n_experts} experts of d_ff {mc.d_ff_expert}, top-{mc.top_k}, "
          f"{mc.n_shared} shared, capacity factor {mc.capacity_factor}, "
          f"vocab {cfg.vocab_size}; {cfg.param_count():,} parameters "
          f"({cfg.active_param_count():,} active), seeded random weights "
          f"drawn leaf by leaf in {init_s:.2f} s: {w_bytes / 1e9:.2f} GB, "
          f"peak {init_peak / 1e9:.2f} GB")

    prompts, gens = churn(cfg)
    kw = dict(slots=SERVE["slots"], gen=SERVE["gen"], gens=gens,
              block_k=SERVE["block_k"])
    splitmax_attn.launches = K.launches = 0
    stats = srv.serve_paged(params, cfg, prompts, warmup=True, **kw)
    torch.cuda.synchronize()
    n_prefill, n_decode = splitmax_attn.launches, K.launches
    check_served(stats, gens, cfg.vocab_size, "moe churn")
    n_warm = (stats["warmup_prefills"], stats["warmup_decode_steps"])
    check(n_warm == (2, 1), f"moe warm-up ran {n_warm} prefills and decodes")
    check(n_prefill == (stats["slot_prefills"] + n_warm[0]) * cfg.n_layers,
          f"moe prefill launches {n_prefill} != ({stats['slot_prefills']} "
          f"admissions + {n_warm[0]} warm-up) x {cfg.n_layers} layers")
    check(n_decode == (stats["decode_steps"] + n_warm[1]) * cfg.n_layers,
          f"moe decode launches {n_decode} != ({stats['decode_steps']} steps "
          f"+ {n_warm[1]} warm-up) x {cfg.n_layers} layers")
    print(f"[moe] churn {SERVE}: served {stats['served']}, "
          f"{stats['total_tokens']} tokens in {stats['wall_s']:.3f} s, "
          f"{stats['tok_s']:.1f} tok/s, {stats['decode_steps']} decode steps, "
          f"{stats['slot_prefills']} slot prefills "
          f"({stats['slot_prefills'] - SERVE['slots']} of them admitted "
          f"while others decode), p50/p99 step "
          f"{stats['p50_step_ms']:.2f}/{stats['p99_step_ms']:.2f} ms, leaked "
          f"{stats['leaked_blocks']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
          f"prefill {n_prefill} decode {n_decode} (warm-up included)")
    profile_serving(torch, srv, params, cfg, prompts[:SERVE["slots"]])

    gamma = SPEC["gamma"]
    rows_agree(torch, dev, params, cfg, SERVE["slots"], gamma)
    # warm-up: the verify GEMM shapes (M = slots * gamma)
    srv.serve(params, cfg, prompts[:2], slots=2, gen=4, gamma=gamma,
              draft="self", block_k=SERVE["block_k"])
    torch.cuda.synchronize()
    splitmax_attn.launches = K.launches = K.verify_launches = 0
    spec = srv.serve_speculative(params, cfg, prompts, gamma=gamma, **kw)
    torch.cuda.synchronize()
    n_pre, n_dec, n_ver = (splitmax_attn.launches, K.launches,
                           K.verify_launches)
    check_served(spec, gens, cfg.vocab_size, "moe speculative")
    check(n_ver == spec["verify_steps"] * cfg.n_layers > 0,
          f"moe speculative: verify launches {n_ver} != "
          f"{spec['verify_steps']} rounds x {cfg.n_layers}")
    check(n_dec == spec["draft_steps"] * gamma * cfg.n_layers,
          f"moe speculative: decode launches {n_dec} != "
          f"{spec['draft_steps']} x {gamma} x {cfg.n_layers}")
    check(n_pre == spec["slot_prefills"] * cfg.n_layers,
          f"moe speculative: prefill launches {n_pre} != "
          f"{spec['slot_prefills']} x {cfg.n_layers}")
    same = sum(spec["finished"][r] == stats["finished"][r]
               for r in stats["finished"])
    check(same == len(stats["finished"]),
          f"moe speculative: tokens differ from plain serving in "
          f"{len(stats['finished']) - same} requests")
    print(f"[moe] speculative self gamma {gamma}: served {spec['served']}, "
          f"{spec['total_tokens']} tokens in {spec['wall_s']:.3f} s, "
          f"{spec['tok_s']:.1f} tok/s (plain {stats['tok_s']:.1f}), "
          f"{spec['verify_steps']} rounds, p50/p99 round "
          f"{spec['p50_step_ms']:.2f}/{spec['p99_step_ms']:.2f} ms, "
          f"accept_rate {spec['accept_rate']:.4f}, tokens == plain "
          f"({same}/{len(stats['finished'])}), leaked "
          f"{spec['leaked_blocks']}, launches prefill {n_pre} decode {n_dec} "
          f"verify {n_ver}")

    moe_layer_check(torch, params, cfg, prompts[0])
    print(f"[moe] phase wall time {time.perf_counter() - t_phase:.1f} s, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB")
    del params
    torch.cuda.empty_cache()
    return {"splitmax_attention": n_prefill,
            "splitmax_decode_fused_paged": n_decode,
            "splitmax_decode_fused_verify_paged": n_ver}


# ------------------------------------------------------- the dense family --

def dense_smoke_phase(torch, dev):
    """The dense family's other smoke configs: :func:`smoke_arch_check`."""
    t0 = time.perf_counter()
    for arch in DENSE_SMOKE_ARCHS:
        smoke_arch_check(torch, dev, arch, "dense-smoke")
    print(f"[dense-smoke] phase wall time {time.perf_counter() - t0:.1f} s")


def dense_full_phase(torch, dev, arch: str, *, speculative: bool,
                     int8: bool = False, requests: int = SERVE["requests"],
                     gen: int = SERVE["gen"], tag: str = "dense"):
    """``arch`` at full width on the card, drawn leaf by leaf in bf16 (the
    LM head, or a tied embedding table, f32), or with ``int8`` as int8
    serve weights (``serve_param_dtype="int8"``: each layer, the table and
    the head drawn in f32 and quantized at once): the churn of
    ``requests`` (gens up to ``gen``; more requests than slots, so that
    some are admitted while others decode) through ``serve_paged`` with
    its warm-up; with
    ``speculative`` also one batch under the profiler, the row-count check
    and the churn through ``serve_speculative`` self-drafted at gamma 4
    (tokens those of the plain churn where the row check says they must
    be); with ``int8`` also the composed churn (``attn_fused=False``, the
    fused churn's tokens).  Returns the main paths' launches of kernels 1,
    2 and 3 (1 and 2 from the plain churn, 3 from the speculative one) and,
    with ``int8``, 5 (the composed churn)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import splitmax_attn, splitmax_decode as K
    from repro_torch.kernels import w8_linear
    from repro_torch.launch import serve as srv
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(arch).config
    if int8:
        cfg = cfg.replace(serve_param_dtype="int8")
    name = cfg.name
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SERVE["seed"], device=dev, serving=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    free, total = torch.cuda.mem_get_info()
    # never the f32 masters: at most the largest f32 draw (the padded vocab
    # x d_model table or head) and its bf16 copy beside the weights; with
    # int8 (a whole layer drawn in f32, then quantized in its own storage)
    # the largest draw and its int8 payload, and no draw alive once it is
    # quantized.  max_memory_allocated counts what was resident before the
    # phase too.
    f32_draw = 4 * max(
        L.pad_vocab(cfg.vocab_size, cfg.vocab_pad_multiple) * cfg.d_model,
        max(sum(x.numel() for x in tree_leaves(lp))
            for lp in params["layers"]) if int8 else 0)
    over = f32_draw * (1.25 if int8 else 2)
    check(init_peak <= resident + w_bytes + over, f"{name} init: peak "
          f"{init_peak / 1e9:.2f} GB for {w_bytes / 1e9:.2f} GB of weights "
          f"and {resident / 1e9:.2f} GB resident before (allowed "
          f"{over / 1e9:.2f} GB over them)")
    how = ("drawn layer by layer in f32 and quantized (int8 serve weights)"
           if int8 else "drawn leaf by leaf (bf16)")
    print(f"[{tag}] {name} at full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd} "
          f"(q columns {cfg.n_heads * cfg.hd}), d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, norm {cfg.norm}, qk_norm {cfg.qk_norm}, tied "
          f"{cfg.tie_embeddings}, rope {cfg.rope_theta:g}; "
          f"{cfg.param_count():,} parameters, seeded random weights "
          f"{how} in "
          f"{init_s:.2f} s: {w_bytes / 1e9:.2f} GB, peak "
          f"{init_peak / 1e9:.2f} GB ({resident / 1e9:.2f} GB resident "
          f"before); mem_get_info after init: {free / 1e9:.2f} GB free of "
          f"{total / 1e9:.2f} GB")

    prompts, gens = churn(cfg, requests, gen)
    kw = dict(slots=SERVE["slots"], gen=gen, gens=gens,
              block_k=SERVE["block_k"])
    if requests != SERVE["requests"] or gen != SERVE["gen"]:
        print(f"[{tag}] {name}: the churn cut to its first {requests} "
              f"requests, gens in [{gen // 2}, {gen}] (every forward "
              f"dequantizes {w_bytes / 1e9:.1f} GB of int8 weights)"
              if int8 else f"[{tag}] {name}: the churn cut to {requests} "
              f"requests, gens in [{gen // 2}, {gen}]")
    splitmax_attn.launches = K.launches = w8_linear.launches = 0
    stats = srv.serve_paged(params, cfg, prompts, warmup=True, **kw)
    torch.cuda.synchronize()
    n_prefill, n_decode = splitmax_attn.launches, K.launches
    n_w8 = w8_linear.launches
    check_served(stats, gens, cfg.vocab_size, f"{name} churn")
    # more requests than slots and unequal first gens: a slot retires while
    # the others decode, and the next request is admitted into it
    check(stats["slot_prefills"] > SERVE["slots"]
          and len(set(gens[:SERVE["slots"]])) > 1,
          f"{name}: no request admitted while others decode")
    n_warm = (stats["warmup_prefills"], stats["warmup_decode_steps"])
    check(n_warm == (2, 1), f"{name} warm-up ran {n_warm} prefills and "
          f"decodes")
    check(n_prefill == (stats["slot_prefills"] + n_warm[0]) * cfg.n_layers,
          f"{name} prefill launches {n_prefill} != ({stats['slot_prefills']} "
          f"admissions + {n_warm[0]} warm-up) x {cfg.n_layers} layers")
    check(n_decode == (stats["decode_steps"] + n_warm[1]) * cfg.n_layers,
          f"{name} decode launches {n_decode} != ({stats['decode_steps']} "
          f"steps + {n_warm[1]} warm-up) x {cfg.n_layers} layers")
    # kernel 9: seven linears a layer at each decode step's rows of int8
    # weights in bf16 (the prompts' admissions take more than 64 rows)
    w8_decode = 7 * (stats["decode_steps"] + n_warm[1]) * cfg.n_layers
    on_w8 = int8 and cfg.compute_dtype == torch.bfloat16
    check(n_w8 == w8_decode * on_w8, f"{name} w8_linear launches {n_w8} "
          f"!= {w8_decode} decode-step linears (int8 in bf16: {on_w8})")
    print(f"[{tag}] {name} churn of {requests} requests, {SERVE['slots']} "
          f"slots, {SERVE['prompt_len']}-token prompts, gens to {gen}: "
          f"served {stats['served']}, "
          f"{stats['total_tokens']} tokens in {stats['wall_s']:.3f} s, "
          f"{stats['tok_s']:.1f} tok/s, {stats['decode_steps']} decode steps, "
          f"{stats['slot_prefills']} slot prefills "
          f"({stats['slot_prefills'] - SERVE['slots']} of them admitted "
          f"while others decode), p50/p99 step "
          f"{stats['p50_step_ms']:.2f}/{stats['p99_step_ms']:.2f} ms, leaked "
          f"{stats['leaked_blocks']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
          f"prefill {n_prefill} decode {n_decode} w8_linear {n_w8} (warm-up "
          f"included)")
    n_ver = 0
    if speculative:
        profile_serving(torch, srv, params, cfg, prompts[:SERVE["slots"]])
        gamma = SPEC["gamma"]
        agree = rows_agree(torch, dev, params, cfg, SERVE["slots"], gamma)
        # warm-up: the verify GEMM shapes (M = slots * gamma)
        srv.serve(params, cfg, prompts[:2], slots=2, gen=4, gamma=gamma,
                  draft="self", block_k=SERVE["block_k"])
        torch.cuda.synchronize()
        splitmax_attn.launches = K.launches = K.verify_launches = 0
        spec = srv.serve_speculative(params, cfg, prompts, gamma=gamma, **kw)
        torch.cuda.synchronize()
        n_pre, n_dec, n_ver = (splitmax_attn.launches, K.launches,
                               K.verify_launches)
        check_served(spec, gens, cfg.vocab_size, f"{name} speculative")
        check(n_ver == spec["verify_steps"] * cfg.n_layers > 0,
              f"{name} speculative: verify launches {n_ver} != "
              f"{spec['verify_steps']} rounds x {cfg.n_layers}")
        check(n_dec == spec["draft_steps"] * gamma * cfg.n_layers,
              f"{name} speculative: decode launches {n_dec} != "
              f"{spec['draft_steps']} x {gamma} x {cfg.n_layers}")
        check(n_pre == spec["slot_prefills"] * cfg.n_layers,
              f"{name} speculative: prefill launches {n_pre} != "
              f"{spec['slot_prefills']} x {cfg.n_layers}")
        same = sum(spec["finished"][r] == stats["finished"][r]
                   for r in stats["finished"])
        if agree:
            check(same == len(stats["finished"]),
                  f"{name} speculative: tokens differ from plain serving in "
                  f"{len(stats['finished']) - same} requests")
        print(f"[{tag}] {name} speculative self gamma {gamma}: served "
              f"{spec['served']}, {spec['total_tokens']} tokens in "
              f"{spec['wall_s']:.3f} s, {spec['tok_s']:.1f} tok/s (plain "
              f"{stats['tok_s']:.1f}), {spec['verify_steps']} rounds, p50/p99 "
              f"round {spec['p50_step_ms']:.2f}/{spec['p99_step_ms']:.2f} ms, "
              f"accept_rate {spec['accept_rate']:.4f}, tokens == plain in "
              f"{same}/{len(stats['finished'])} requests (required: {agree}), "
              f"leaked {spec['leaked_blocks']}, launches prefill {n_pre} "
              f"decode {n_dec} verify {n_ver}")
    out = {"splitmax_attention": n_prefill,
           "splitmax_decode_fused_paged": n_decode,
           "splitmax_decode_fused_verify_paged": n_ver, "w8_linear": n_w8}
    if int8:
        K.launches = K.composed_launches = 0
        comp = srv.serve_paged(params, cfg.replace(attn_fused=False), prompts,
                               **kw)
        torch.cuda.synchronize()
        n_comp = K.composed_launches
        check_served(comp, gens, cfg.vocab_size, f"{name} composed churn")
        check(n_comp == comp["decode_steps"] * cfg.n_layers > 0
              and K.launches == 0,
              f"{name} composed launches {n_comp} (fused {K.launches}) != "
              f"{comp['decode_steps']} steps x {cfg.n_layers}")
        check(comp["finished"] == stats["finished"],
              f"{name}: composed tokens differ from the fused churn's")
        print(f"[{tag}] {name} composed churn (attn_fused=False): "
              f"{served_line(comp, torch)}, tokens == fused, composed "
              f"launches {n_comp}")
        out["splitmax_decode_paged"] = n_comp
    print(f"[{tag}] {name} phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s, weights "
          f"{w_bytes / 1e9:.2f} GB, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    torch.cuda.empty_cache()
    return out


def profile_serving(torch, srv, params, cfg, prompts, gen: int = 8,
                    frames=None, cache_kind: str = "paged"):
    """Where the time goes: one full batch (8 admissions, or one batch
    prefill with ``cache_kind="dense"``, then decode steps) under
    torch.profiler; device busy share and the top kernels.  ``frames``:
    the encoder inputs of an encoder-decoder config."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = srv.serve(params, cfg, prompts, slots=len(prompts), gen=gen,
                          block_k=SERVE["block_k"], frames=frames,
                          cache_kind=cache_kind)
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
    print(f"[profile] {cfg.name}: {len(prompts)} requests "
          f"({stats['slot_prefills']} slot prefills, "
          f"{stats['batch_prefills']} batch prefills) + "
          f"{stats['decode_steps']} decode steps under the profiler: wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%)")
    for key, count, ms in rows[:10]:
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  "
              f"x{count:<5d} {key[:90]}")
    mine = {}
    for what, tag in (("prefill", "splitmax_attn_kernel"),
                      ("decode", "decode_kernel<")):
        hit = [(c, ms) for key, c, ms in rows if tag in key]
        mine[what] = (sum(c for c, _ in hit), sum(ms for _, ms in hit))
    both = mine["prefill"][1] + mine["decode"][1]
    print(f"[profile] split-softmax kernels: prefill {mine['prefill'][1]:.3f} "
          f"ms over {mine['prefill'][0]} launches, decode "
          f"{mine['decode'][1]:.3f} ms over {mine['decode'][0]} launches, "
          f"together {both:.3f} ms ({100 * both / busy_ms:.1f}% of device "
          f"busy)")


# ------------------------------------------------------- encoder-decoder --

def encdec_churn(cfg):
    """The churn workload with encoder inputs: SERVE's prompts, then one
    (prompt_len, d_model) frame array a request drawn as the serving CLI
    draws them (normal x 0.02, f32, after the prompts from the same
    generator), then the staggered gens."""
    import numpy as np
    rng = np.random.default_rng(SERVE["seed"])
    n, s = SERVE["requests"], SERVE["prompt_len"]
    prompts = [rng.integers(0, cfg.vocab_size, s, dtype=np.int32)
               for _ in range(n)]
    frames = [np.asarray(rng.normal(size=(s, cfg.d_model)), np.float32) * 0.02
              for _ in range(n)]
    gens = [int(g) for g in rng.integers(SERVE["gen"] // 2, SERVE["gen"] + 1,
                                         n)]
    return prompts, frames, gens


def encdec_smoke_logits(torch, params, cfg, tokens, frames, device,
                        steps: int = 8):
    """Paged (the carved bank) and dense-cache prefill of ``tokens (1, S)``
    over ``frames (1, S_enc, d)`` and ``steps`` greedy decode steps on
    ``device``: both runs' stacked logits, on the CPU."""
    from repro_torch.models import encdec as E
    p = tree_to(params, device)
    tok = torch.as_tensor(tokens, device=device)
    fr = torch.as_tensor(frames, device=device)
    enc = fr.shape[1]
    cbps = -(-enc // 8)
    cache = E.make_paged_cache(cfg, 1, 40, block_k=8, num_blocks=6 + cbps,
                               cross_table=[list(range(1, 1 + cbps))],
                               enc_len=enc, device=device)
    row = torch.arange(1 + cbps, 6 + cbps, dtype=torch.int32,
                       device=device)[None]
    sid = torch.zeros(1, dtype=torch.int32, device=device)
    last, cache = E.prefill_paged(p, fr, tok, cfg, cache, sid, row,
                                  calibrate=True)
    dense = E.make_cache(cfg, 1, 40, enc, device=device)
    d_last, dense = E.prefill(p, fr, tok, cfg, dense)
    outs, d_outs = [last], [d_last]
    nxt = torch.argmax(last, -1)
    for _ in range(steps):
        logits, cache = E.decode_step_paged(p, nxt, cfg, cache)
        d_logits, dense = E.decode_step(p, nxt, cfg, dense)
        outs.append(logits)
        d_outs.append(d_logits)
        nxt = torch.argmax(logits, -1)
    return torch.stack(outs).cpu(), torch.stack(d_outs).cpu()


def encdec_smoke_check(torch, dev) -> None:
    """The encoder-decoder smoke config in f32, kernels on the card vs
    plain versions on the CPU, same weights: paged and dense-cache prefill
    logits and 8 decode steps within 2e-3 of the logits' scale, and the
    tokens of a 6-request churn (fused and composed) equal."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as srv
    from repro_torch.models import encdec as E

    cpu = torch.device("cpu")
    cfg = get_arch(SEAMLESS_ARCH).smoke.replace(dtype="float32")
    params = E.init_params(cfg, seed=0, device=cpu)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (1, 20))
    frames = np.asarray(rng.normal(size=(1, 24, cfg.d_model)),
                        np.float32) * 0.02
    errs = []
    for gpu, ref, what in zip(
            encdec_smoke_logits(torch, params, cfg, tokens, frames, dev),
            encdec_smoke_logits(torch, params, cfg, tokens, frames, cpu),
            ("paged", "dense cache")):
        err = float((gpu - ref).abs().max())
        scale = float(ref.abs().max())
        check(bool(torch.isfinite(gpu).all()), f"encdec smoke {what}: "
              f"non-finite")
        check(err <= 2e-3 * scale, f"encdec smoke {what}: max|gpu-cpu| "
              f"logits {err:.3g} > 2e-3 * {scale:.3g}")
        errs.append(f"{what} {err:.3g} of {scale:.3g}")
    prompts = [rng.integers(0, cfg.vocab_size, 24, dtype=np.int32)
               for _ in range(6)]
    fr = [np.asarray(rng.normal(size=(24, cfg.d_model)), np.float32) * 0.02
          for _ in range(6)]
    gens = [int(g) for g in rng.integers(8, 17, 6)]
    kw = dict(slots=3, gen=16, gens=gens, block_k=8, frames=fr)
    for fused in (True, False):
        c = cfg.replace(attn_fused=fused)
        on_card = srv.serve_paged(tree_to(params, dev), c, prompts, **kw)
        on_cpu = srv.serve_paged(params, c, prompts, **kw)
        check_served(on_card, gens, cfg.vocab_size, "encdec smoke churn")
        check(on_card["finished"] == on_cpu["finished"],
              f"encdec smoke churn (fused={fused}): card tokens differ from "
              f"the CPU's")
    print(f"[encdec-smoke] {cfg.name} (f32), card vs CPU plain path: "
          f"prefill + 8 decode steps max|logit diff| {', '.join(errs)} (tol "
          f"2e-3 of the scale); 6-request churn (24 frames, fused and "
          f"composed) tokens == CPU tokens")


def seamless_kernel_shapes(torch, F, dev, params, cfg, prompts, frames):
    """Kernel 1 at SeamlessM4T's three attentions (16/16 heads of 64) and
    kernels 2 and 5 over the 8-slot carved cross bank of a full-width
    engine (full pool) with every slot admitted, each bit for bit its
    ``exact=True``
    plain version and within ``tolerance`` of the default one; kernels 2
    and 5 also over a bank whose slots were never written (idle slots:
    finite).  Each is timed by graph replay beside its bound and SDPA's
    bf16 kernel (non-causal where the kernel is).  Returns each kernel's
    sub-entry for the JSON line."""
    from repro_torch.core import paged_kv
    from repro_torch.core import quantization as qlib
    from repro_torch.core.attention import luts_for
    from repro_torch.core.lut import LUTConfig
    from repro_torch.kernels import ops, splitmax_attn as KA
    from repro_torch.kernels import splitmax_decode as KD
    from repro_torch.launch import serve as srv

    lcfg = LUTConfig(scale_z=8.0 / 127)
    exp_lut, recip_lut = luts_for(lcfg.scale_z, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    hq, hkv, d = (SEAMLESS_HEADS[k] for k in ("hq", "hkv", "d"))
    fns, entries, errs = {}, {}, {}
    for key, sq, sk, causal in SEAMLESS_PREFILL:
        q = torch.randn((1, hq, sq, d), generator=gen, device=dev)
        k = torch.randn((1, hkv, sk, d), generator=gen, device=dev)
        v = torch.randn((1, hkv, sk, d), generator=gen, device=dev)
        s_q, s_k, s_v = (qlib.absmax_scale(x) for x in (q, k, v))
        args = (qlib.quantize(q, s_q), qlib.quantize(k, s_k),
                qlib.quantize(v, s_v),
                ops.requant_multiplier(s_q, s_k, d, lcfg).reshape(()), s_v,
                exp_lut, recip_lut)
        kw = dict(cfg=lcfg, causal=causal)
        ker = KA.splitmax_attention_cuda(*args, **kw)
        exact = KA.splitmax_attention_plain(*args, exact=True, **kw)
        plain = KA.splitmax_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err, tol = float((ker - plain).abs().max()), tolerance(float(s_v))
        check(torch.equal(ker, exact), f"seamless prefill {key} {sq}x{sk}: "
              f"kernel != the exact=True plain version")
        check(err <= tol, f"seamless prefill {key}: max|kernel-plain| "
              f"{err:.3g} > {tol:.3g}")
        fns[f"prefill {key}"] = (lambda a=args, w=kw:
                                 KA.splitmax_attention_cuda(*a, **w))
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        fns[f"prefill {key} sdpa"] = (
            lambda a=(qb, kb, vb), c=causal:
            F.scaled_dot_product_attention(*a, is_causal=c))
        pairs = hq * (sq * (sq + 1) // 2 if causal else sq * sk)
        n_bytes = (hq * sq * d + 2 * hkv * sk * d + 4 * hq * sq * d
                   + 4 * (256 + lcfg.recip_table_size))
        bms, by = bound_ms(n_bytes, pairs * 6 * d)
        plain_ms = time_ms(torch, lambda a=args, w=kw:
                           KA.splitmax_attention_plain(*a, **w), iters=5)
        entries[f"prefill {key}"] = {
            "shape": dict(b=1, sq=sq, sk=sk, causal=causal, **SEAMLESS_HEADS),
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": err}
        errs["splitmax_attention"] = max(errs.get("splitmax_attention", 0),
                                         err)
        print(f"[seamless-kernels] prefill {key} 1 x {hq}/{hkv} x {sq} x "
              f"{sk} d{d} causal={causal}: == exact oracle, max_abs_err "
              f"{err:.3g} (tol {tol:.3g}), plain {plain_ms:.4f} ms, bound "
              f"{bms:.5f} ms ({by})")

    # the carved bank as the churn leaves it: every slot admitted
    engine = srv.make_engine(params, cfg, prompts, slots=SERVE["slots"],
                             max_len=SERVE["prompt_len"] + SERVE["gen"] + 8,
                             block_k=SERVE["block_k"], frames=frames)
    cache = engine.start_run()
    for slot in range(engine.slots):
        engine.admit(cache, slot, slot)
    kvc = cache["kv"]
    layer = engine.cfg.n_layers // 2
    table, lens = cache["cross_table"], cache["cross_len"]
    s_k = cache["cross_scale_k"][layer].reshape(())
    s_v = cache["cross_scale_v"][layer].reshape(())
    b = engine.slots
    q = torch.randn((b, hq, d), generator=gen, device=dev)
    s_q = qlib.absmax_scale(q, axis=(1, 2)).reshape(-1)
    m_z = ops.requant_multiplier(s_q, s_k, d, lcfg)
    kp, vp = kvc["k_pages"][layer], kvc["v_pages"][layer]
    fused = [q, kp, vp, table, m_z, s_q, s_v, lens, exp_lut, recip_lut]
    composed = [qlib.quantize(q, s_q[:, None, None]), kp, vp, table, m_z,
                s_v, lens, exp_lut, recip_lut]
    tol = tolerance(float(s_v))
    outs = {}
    for name, kern, plain, args in (
            ("decode", KD.splitmax_decode_fused_paged_cuda,
             KD.splitmax_decode_fused_paged_plain, fused),
            ("composed", KD.splitmax_decode_paged_cuda,
             KD.splitmax_decode_paged_plain, composed)):
        ker = kern(*args, cfg=lcfg)
        exact = plain(*args, cfg=lcfg, exact=True)
        default = plain(*args, cfg=lcfg)
        torch.cuda.synchronize()
        err = float((ker - default).abs().max())
        check(torch.equal(ker, exact), f"seamless {name} over the cross "
              f"bank: kernel != the exact=True plain version")
        check(err <= tol, f"seamless {name} over the cross bank: "
              f"max|kernel-plain| {err:.3g} > {tol:.3g}")
        # never-written bank rows (idle slots): zeros, finite output
        idle = torch.zeros_like(kp)
        z = kern(*[idle if a is kp or a is vp else a for a in args],
                 cfg=lcfg)
        check(bool(torch.isfinite(z).all()), f"seamless {name} over an "
              f"unwritten bank: non-finite")
        outs[name] = ker
        fns[f"{name} cross"] = (lambda f=kern, a=args: f(*a, cfg=lcfg))
        plain_ms = time_ms(torch, lambda f=plain, a=args: f(*a, cfg=lcfg),
                           iters=10)
        total = int(lens.sum())
        tiles = b * table.shape[1]
        q_bytes = 4 if name == "decode" else 1
        n_bytes = (q_bytes * b * hq * d + 2 * hkv * d * total + 4 * tiles
                   + 4 * b * 3 + 4 * b * hq * d
                   + 4 * (256 + lcfg.recip_table_size))
        bms, by = bound_ms(n_bytes, total * hq * 6 * d)
        entries[f"{name} cross"] = {
            "shape": dict(b=b, lens=lens.tolist(), cross_bps=table.shape[1],
                          **SEAMLESS_HEADS),
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": err}
        errs[name] = err
        print(f"[seamless-kernels] {name} over the carved bank ({b} slots x "
              f"{table.shape[1]} blocks, len {lens.tolist()[0]}, layer "
              f"{layer}): == exact oracle, max_abs_err {err:.3g} (tol "
              f"{tol:.3g}), unwritten bank finite, plain {plain_ms:.4f} ms, "
              f"bound {bms:.5f} ms ({by})")
    check(torch.equal(outs["decode"], outs["composed"]), "seamless composed "
          "over the cross bank differs from the fused kernel")
    qb = torch.randn((b, hq, 1, d), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    kb, vb = (torch.randn((b, hq, int(lens[0]), d), generator=gen,
                          device=dev, dtype=torch.bfloat16) for _ in range(2))
    fns["decode cross sdpa"] = lambda: F.scaled_dot_product_attention(qb, kb,
                                                                      vb)
    del cache, engine
    one = torch.zeros(1, device=dev)
    fns["launch floor"] = lambda: one.add_(1)
    times = graph_rounds(torch, fns)
    floor = times.pop("launch floor")[0]
    for key, e in entries.items():
        yard = "decode cross sdpa" if "cross" in key and "prefill" not in key \
            else f"{key} sdpa"
        e["ms"], lo, hi = times[key]
        e["ms_range"] = [lo, hi]
        e["library_ms"] = times[yard][0]
        e["launch_floor_ms"] = floor
        print(f"[seamless-kernels] {key}: kernel {e['ms']:.5f} ms ({lo:.5f}-"
              f"{hi:.5f}), bound {e['bound_ms']:.5f} ms ({e['bound_by']}), "
              f"SDPA bf16 {e['library_ms']:.5f} ms, launch floor "
              f"{floor:.5f} ms")
    return {"splitmax_attention": {k[len("prefill "):]: v for k, v in
                                   entries.items() if k.startswith("prefill")},
            "splitmax_decode_fused_paged": entries["decode cross"],
            "splitmax_decode_paged": entries["composed cross"]}, errs


def encdec_full_phase(torch, F, dev):
    """SeamlessM4T-medium at full width on the card, drawn leaf by leaf in
    bf16 (the tied f32 embedding table is the LM head): the churn through
    ``serve_paged`` with frames and its warm-up, the composed churn
    (``--fused off``) and a pressure churn over a 51-block dynamic pool
    with the carved bank on top (both the plain tokens), one profiled
    batch, and the kernel shapes (:func:`seamless_kernel_shapes`).  Returns
    the main paths' launches of kernels 1, 2 and 5 and the kernels'
    sub-entries."""
    from repro_torch.configs import get_arch
    from repro_torch.core import paged_kv
    from repro_torch.kernels import splitmax_attn, splitmax_decode as K
    from repro_torch.launch import scheduler as sched
    from repro_torch.launch import serve as srv
    from repro_torch.models import encdec as E
    from repro_torch.models import layers as L

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(SEAMLESS_ARCH).config
    name = cfg.name
    n_enc = cfg.n_encoder_layers or cfg.n_layers
    t0 = time.perf_counter()
    params = E.init_params(cfg, seed=SERVE["seed"], device=dev, serving=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    f32_draw = 4 * L.pad_vocab(cfg.vocab_size,
                               cfg.vocab_pad_multiple) * cfg.d_model
    check(init_peak <= w_bytes + 2 * f32_draw, f"{name} init: peak "
          f"{init_peak / 1e9:.2f} GB for {w_bytes / 1e9:.2f} GB of weights")
    print(f"[encdec] {name} at full width: {n_enc} encoder + {cfg.n_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, norm {cfg.norm}, act {cfg.act}, tied "
          f"{cfg.tie_embeddings}; {cfg.param_count():,} parameters, seeded "
          f"random weights drawn leaf by leaf in {init_s:.2f} s: "
          f"{w_bytes / 1e9:.2f} GB, peak {init_peak / 1e9:.2f} GB")

    prompts, frames, gens = encdec_churn(cfg)
    kw = dict(slots=SERVE["slots"], gen=SERVE["gen"], gens=gens,
              block_k=SERVE["block_k"], frames=frames)
    per_admit = n_enc + 2 * cfg.n_layers       # encoder, self, cross
    splitmax_attn.launches = K.launches = 0
    stats = srv.serve_paged(params, cfg, prompts, warmup=True, **kw)
    torch.cuda.synchronize()
    n_prefill, n_decode = splitmax_attn.launches, K.launches
    check_served(stats, gens, cfg.vocab_size, f"{name} churn")
    # more requests than slots and unequal first gens: a slot retires while
    # the others decode, and the next request is admitted into it
    check(stats["slot_prefills"] > SERVE["slots"]
          and len(set(gens[:SERVE["slots"]])) > 1,
          f"{name}: no request admitted while others decode")
    n_warm = (stats["warmup_prefills"], stats["warmup_decode_steps"])
    check(n_warm == (2, 1), f"{name} warm-up ran {n_warm} prefills and "
          f"decodes")
    check(n_prefill == (stats["slot_prefills"] + n_warm[0]) * per_admit,
          f"{name} prefill launches {n_prefill} != ({stats['slot_prefills']} "
          f"admissions + {n_warm[0]} warm-up) x {per_admit} attentions")
    check(n_decode == (stats["decode_steps"] + n_warm[1]) * 2 * cfg.n_layers,
          f"{name} decode launches {n_decode} != ({stats['decode_steps']} "
          f"steps + {n_warm[1]} warm-up) x 2 x {cfg.n_layers} layers")
    bps = paged_kv.blocks_per_seq(SERVE["prompt_len"] + SERVE["gen"] + 8,
                                  SERVE["block_k"])
    cross_bps = paged_kv.blocks_per_seq(SERVE["prompt_len"], SERVE["block_k"])
    pool = stats["health"]["pools"]["kv"]
    carved = pool["num_blocks"] - (1 + SERVE["slots"] * bps)
    check(carved == SERVE["slots"] * cross_bps, f"{name}: pool of "
          f"{pool['num_blocks']} blocks, {carved} beyond the dynamic region")
    print(f"[encdec] {name} churn {SERVE} with {SERVE['prompt_len']} x "
          f"{cfg.d_model} frames: served {stats['served']}, "
          f"{stats['total_tokens']} tokens in {stats['wall_s']:.3f} s, "
          f"{stats['tok_s']:.1f} tok/s, {stats['decode_steps']} decode steps, "
          f"{stats['slot_prefills']} slot prefills "
          f"({stats['slot_prefills'] - SERVE['slots']} of them admitted "
          f"while others decode), p50/p99 step "
          f"{stats['p50_step_ms']:.2f}/{stats['p99_step_ms']:.2f} ms, leaked "
          f"{stats['leaked_blocks']}, pool {pool['num_blocks']} blocks "
          f"(carved bank {carved} = {SERVE['slots']} slots x {cross_bps}), "
          f"high water {pool['high_water']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
          f"prefill {n_prefill} decode {n_decode} (warm-up included)")

    K.launches = K.composed_launches = 0
    comp = srv.serve_paged(params, cfg.replace(attn_fused=False), prompts,
                           **kw)
    torch.cuda.synchronize()
    n_comp = K.composed_launches
    check_served(comp, gens, cfg.vocab_size, f"{name} composed churn")
    check(n_comp == comp["decode_steps"] * 2 * cfg.n_layers and K.launches == 0,
          f"{name} composed launches {n_comp} (fused {K.launches}) != "
          f"{comp['decode_steps']} steps x 2 x {cfg.n_layers}")
    check(comp["finished"] == stats["finished"], f"{name} composed churn: "
          f"tokens differ from the fused churn's")
    print(f"[encdec] {name} composed churn: {comp['tok_s']:.1f} tok/s, p50 "
          f"step {comp['p50_step_ms']:.2f} ms, tokens == fused, composed "
          f"launches {n_comp}")

    dyn = 1 + PRESSURE_POOL_SEQS * bps
    engine = srv.make_engine(params, cfg, prompts, slots=SERVE["slots"],
                             max_len=SERVE["prompt_len"] + SERVE["gen"] + 8,
                             block_k=SERVE["block_k"], pool_blocks=dyn,
                             frames=frames)
    press = sched.run_schedule(engine, prompts, gens=gens)
    torch.cuda.synchronize()
    what = f"{name} pressure churn (dynamic pool {dyn})"
    check_served(press, gens, cfg.vocab_size, what)
    check(press["preemptions"] >= 1
          and press["resumes"] == press["preemptions"],
          f"{what}: {press['preemptions']} preemptions, {press['resumes']} "
          f"resumes")
    check(press["finished"] == stats["finished"], f"{what}: tokens differ "
          f"from the plain churn's")
    a = engine.alloc
    check(a.live_count == 0 and a.carved_count == SERVE["slots"] * cross_bps
          and a.free_count == a.num_blocks - 1 - a.carved_count,
          f"{what}: the pool does not end empty ({a.live_count} live, "
          f"{a.carved_count} carved, {a.free_count} free of {a.num_blocks})")
    print(f"[encdec] {what}: served {press['served']}, {press['tok_s']:.1f} "
          f"tok/s (plain {stats['tok_s']:.1f}), {press['decode_steps']} "
          f"decode steps, {press['preemptions']} preemptions, "
          f"{press['resumes']} resumes, tokens == plain, pool ends empty "
          f"(carved_count {a.carved_count})")

    profile_serving(torch, srv, params, cfg, prompts[:SERVE["slots"]],
                    frames=frames[:SERVE["slots"]])
    del engine
    subs, errs = seamless_kernel_shapes(torch, F, dev, params, cfg, prompts,
                                        frames)
    print(f"[encdec] {name} phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    torch.cuda.empty_cache()
    return ({"splitmax_attention": n_prefill,
             "splitmax_decode_fused_paged": n_decode,
             "splitmax_decode_paged": n_comp}, subs, errs)




# ------------------------------------------------------- SSM and hybrid --

def ssm_smoke_logits(torch, params, cfg, tokens, device, steps: int = 8):
    """Dense-cache prefill of ``tokens (1, S)`` and ``steps`` greedy decode
    steps on ``device``, and for the SSM family the same through the int8
    state-slab engine (admission, then decode steps of its one slot): the
    stacked logits of each run, on the CPU."""
    from repro_torch.launch.engines import SSMStateEngine
    from repro_torch.models import transformer as T
    p = tree_to(params, device)
    tok = torch.as_tensor(tokens, device=device)
    cache = T.make_cache(cfg, 1, 40, device=device)
    last, cache = T.prefill(p, tok, cfg, cache)
    outs = [last]
    nxt = torch.argmax(last, -1)
    for _ in range(steps):
        logits, cache = T.decode_step(p, nxt, cfg, cache)
        outs.append(logits)
        nxt = torch.argmax(logits, -1)
    runs = [torch.stack(outs).cpu()]
    if cfg.family == "ssm":
        eng = SSMStateEngine(p, cfg, [tokens[0]], slots=1, max_len=40)
        last, cache = eng.admit(eng.start_run(), 0, 0)
        outs = [last]
        nxt = torch.argmax(last, -1)
        for _ in range(steps):
            logits, cache = eng.decode(nxt, cache)
            outs.append(logits)
            nxt = torch.argmax(logits, -1)
        runs.append(torch.stack(outs).cpu())
    return runs


def ssm_smoke_check(torch, dev) -> None:
    """Both smoke configs of the SSM and hybrid families in f32, kernels on
    the card vs plain versions on the CPU, same weights: prefill + 8 decode
    steps within 2e-3 of the logits' scale (dense cache; Falcon-Mamba also
    through the state-slab engine), and a 6-request churn's tokens equal:
    Falcon-Mamba paged (the engine) and dense, Zamba2 dense fused and
    composed."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    for arch in (SSM_ARCH, HYBRID_ARCH):
        cfg = get_arch(arch).smoke.replace(dtype="float32")
        params = T.init_params(cfg, seed=0, device=cpu)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, (1, 20))
        errs = []
        for gpu, ref, what in zip(
                ssm_smoke_logits(torch, params, cfg, tokens, dev),
                ssm_smoke_logits(torch, params, cfg, tokens, cpu),
                ("dense cache", "state slabs")):
            err = float((gpu - ref).abs().max())
            scale = float(ref.abs().max())
            check(bool(torch.isfinite(gpu).all()), f"{arch} smoke {what}: "
                  f"non-finite")
            check(err <= 2e-3 * scale, f"{arch} smoke {what}: max|gpu-cpu| "
                  f"logits {err:.3g} > 2e-3 * {scale:.3g}")
            errs.append(f"{what} {err:.3g} of {scale:.3g}")
        prompts = [rng.integers(0, cfg.vocab_size, 24, dtype=np.int32)
                   for _ in range(6)]
        gens = [int(g) for g in rng.integers(8, 17, 6)]
        runs = ([("paged", cfg), ("dense", cfg)] if cfg.family == "ssm" else
                [("dense", cfg), ("dense", cfg.replace(attn_fused=False))])
        for kind, c in runs:
            kw = dict(slots=3, gen=16, gens=gens, cache_kind=kind)
            on_card = srv.serve(tree_to(params, dev), c, prompts, **kw)
            on_cpu = srv.serve(params, c, prompts, **kw)
            what = f"{arch} smoke {kind} churn (fused={c.attn_fused})"
            check_served(on_card, gens, cfg.vocab_size, what,
                         overshoot=int(kind == "dense"))
            check(on_card["finished"] == on_cpu["finished"],
                  f"{what}: card tokens differ from the CPU's")
        churns = ", ".join(f"{k} fused={c.attn_fused}" for k, c in runs)
        print(f"[ssm-smoke] {cfg.name} (f32), card vs CPU plain path: "
              f"prefill + 8 decode steps max|logit diff| {', '.join(errs)} "
              f"(tol 2e-3 of the scale); 6-request churn tokens == CPU "
              f"tokens ({churns})")


def init_full(torch, dev, arch: str, tag: str):
    """``arch``'s full-width config and its seeded random weights, drawn
    leaf by leaf already cast for serving; checks that the draw never held
    more than the largest f32 leaf beyond the weights."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(arch).config
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SERVE["seed"], device=dev, serving=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    f32_draw = 4 * L.pad_vocab(cfg.vocab_size,
                               cfg.vocab_pad_multiple) * cfg.d_model
    check(init_peak <= w_bytes + 2 * f32_draw, f"{cfg.name} init: peak "
          f"{init_peak / 1e9:.2f} GB for {w_bytes / 1e9:.2f} GB of weights")
    print(f"[{tag}] {cfg.name} at full width: {cfg.n_layers} layers "
          f"({cfg.ssm.kind}), d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
          f"d_state {cfg.ssm.d_state}, vocab {cfg.vocab_size}, tied "
          f"{cfg.tie_embeddings}; {cfg.param_count():,} parameters, seeded "
          f"random weights drawn leaf by leaf in {init_s:.2f} s: "
          f"{w_bytes / 1e9:.2f} GB, peak {init_peak / 1e9:.2f} GB")
    return cfg, params


def served_line(stats, torch) -> str:
    return (f"served {stats['served']}, {stats['total_tokens']} tokens in "
            f"{stats['wall_s']:.3f} s, {stats['tok_s']:.1f} tok/s, "
            f"{stats['decode_steps']} decode steps, p50/p99 step "
            f"{stats['p50_step_ms']:.2f}/{stats['p99_step_ms']:.2f} ms, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def falcon_full_phase(torch, dev) -> None:
    """Falcon-Mamba-7B at full width on the card (bf16, the untied f32 LM
    head): the churn through ``serve_paged`` (the int8 state-slab engine)
    with its warm-up; again under a forced preemption (``FaultPlan``:
    tokens those of the plain churn, 1 preemption, 1 resume); through
    ``--cache dense``; and one profiled batch.  No split-softmax kernel
    runs on these paths (an SSM has no softmax): their counts stay 0."""
    from repro_torch.kernels import splitmax_attn, splitmax_decode as K
    from repro_torch.launch import serve as srv
    from repro_torch.launch.faults import FaultPlan

    t_phase = time.perf_counter()
    cfg, params = init_full(torch, dev, SSM_ARCH, "ssm")
    name = cfg.name
    prompts, gens = churn(cfg)
    kw = dict(slots=SERVE["slots"], gen=SERVE["gen"], gens=gens)
    splitmax_attn.launches = K.launches = K.dense_launches = 0
    torch.cuda.reset_peak_memory_stats()
    stats = srv.serve_paged(params, cfg, prompts, warmup=True, **kw)
    torch.cuda.synchronize()
    check_served(stats, gens, cfg.vocab_size, f"{name} churn")
    # more requests than slots and unequal first gens: a slot retires while
    # the others decode, and the next request is admitted into it
    check(stats["slot_prefills"] > SERVE["slots"]
          and len(set(gens[:SERVE["slots"]])) > 1,
          f"{name}: no request admitted while others decode")
    n_warm = (stats["warmup_prefills"], stats["warmup_decode_steps"])
    check(n_warm == (1, 1), f"{name} warm-up ran {n_warm} prefills and "
          f"decodes")
    check(stats["health"]["pools"] == {}, f"{name}: a pool record "
          f"{stats['health']['pools']} for an engine without a pool")
    n_kernels = splitmax_attn.launches + K.launches + K.dense_launches
    check(n_kernels == 0, f"{name}: {n_kernels} split-softmax launches on "
          f"an attention-free path")
    slab = stats["kv_bytes_per_step"]
    print(f"[ssm] {name} churn {SERVE} through the state-slab engine: "
          f"{served_line(stats, torch)}, {stats['slot_prefills']} slot "
          f"prefills, leaked {stats['leaked_blocks']}, int8 state slabs "
          f"{slab / 1e6:.2f} MB ({cfg.n_layers} layers x {SERVE['slots']} "
          f"slots), split-softmax launches 0")

    plan = FaultPlan(**FORCED_PREEMPT)
    forced = srv.serve_paged(params, cfg, prompts, fault_plan=plan, **kw)
    torch.cuda.synchronize()
    what = f"{name} forced preemption {FORCED_PREEMPT}"
    check_served(forced, gens, cfg.vocab_size, what)
    check((forced["preemptions"], forced["resumes"]) == (1, 1),
          f"{what}: {forced['preemptions']} preemptions, "
          f"{forced['resumes']} resumes")
    same = sum(forced["finished"][r] == stats["finished"][r]
               for r in stats["finished"])
    check(same == len(stats["finished"]), f"{what}: tokens differ from the "
          f"plain churn's in {len(stats['finished']) - same} requests")
    print(f"[ssm] {what}: {served_line(forced, torch)}, 1 preemption, 1 "
          f"resume, {forced['slot_prefills']} slot prefills, tokens == "
          f"plain")

    torch.cuda.reset_peak_memory_stats()
    dense = srv.serve_dense(params, cfg, prompts, **kw)
    torch.cuda.synchronize()
    check_served(dense, gens, cfg.vocab_size, f"{name} dense churn",
                 overshoot=1)
    print(f"[ssm] {name} dense churn: {served_line(dense, torch)}, "
          f"{dense['batch_prefills']} batch prefills (B {SERVE['slots']} x "
          f"{SERVE['prompt_len'] + SERVE['gen']})")
    profile_serving(torch, srv, params, cfg, prompts[:SERVE["slots"]])
    print(f"[ssm] {name} phase wall time {time.perf_counter() - t_phase:.1f} "
          f"s")
    del params
    torch.cuda.empty_cache()


def hybrid_kernel_shapes(torch, F, dev):
    """Kernel 1 at Zamba2's prefills (32/32 heads of 80, causal: the first
    batch's B 8 x 250 and a re-prefill's B 8 x 282) and kernels 4 and 6
    over its dense cache (B 8, S_max 290, the churn's lengths 251..282),
    each bit for bit its ``exact=True`` plain version and within
    ``tolerance`` of the default one, kernels 4 and 6 also bit for bit each
    other and the paged kernel on the same K/V; each timed by graph replay
    beside its bound and SDPA's bf16 kernel.  Returns each kernel's
    sub-entry for the JSON line and its largest error."""
    from repro_torch.core import quantization as qlib
    from repro_torch.core.attention import luts_for
    from repro_torch.core.lut import LUTConfig
    from repro_torch.kernels import ops, splitmax_attn as KA
    from repro_torch.kernels import splitmax_decode as KD

    lcfg = LUTConfig(scale_z=8.0 / 127)
    exp_lut, recip_lut = luts_for(lcfg.scale_z, dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    hq, hkv, d = (HYBRID_HEADS[k] for k in ("hq", "hkv", "d"))
    b = SERVE["slots"]
    fns, entries, errs = {}, {}, {}
    for s in (SERVE["prompt_len"], SERVE["prompt_len"] + SERVE["gen"]):
        key = f"prefill B {b} x {s}"
        q = torch.randn((b, hq, s, d), generator=gen, device=dev)
        k = torch.randn((b, hkv, s, d), generator=gen, device=dev)
        v = torch.randn((b, hkv, s, d), generator=gen, device=dev)
        s_q, s_k, s_v = (qlib.absmax_scale(x) for x in (q, k, v))
        args = (qlib.quantize(q, s_q), qlib.quantize(k, s_k),
                qlib.quantize(v, s_v),
                ops.requant_multiplier(s_q, s_k, d, lcfg).reshape(()), s_v,
                exp_lut, recip_lut)
        kw = dict(cfg=lcfg)
        ker = KA.splitmax_attention_cuda(*args, **kw)
        exact = KA.splitmax_attention_plain(*args, exact=True, **kw)
        plain = KA.splitmax_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err, tol = float((ker - plain).abs().max()), tolerance(float(s_v))
        check(torch.equal(ker, exact), f"zamba2 {key} d{d}: kernel != the "
              f"exact=True plain version")
        check(err <= tol, f"zamba2 {key}: max|kernel-plain| {err:.3g} > "
              f"{tol:.3g}")
        fns[key] = lambda a=args, w=kw: KA.splitmax_attention_cuda(*a, **w)
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        fns[f"{key} sdpa"] = (lambda a=(qb, kb, vb):
                              F.scaled_dot_product_attention(*a,
                                                             is_causal=True))
        n_bytes = b * (hq * s * d + 2 * hkv * s * d + 4 * hq * s * d) + 4 * (
            256 + lcfg.recip_table_size)
        bms, by = bound_ms(n_bytes, b * hq * s * (s + 1) // 2 * 6 * d)
        plain_ms = time_ms(torch, lambda a=args, w=kw:
                           KA.splitmax_attention_plain(*a, **w), iters=3,
                           warm=1)
        entries[key] = {"shape": dict(b=b, s=s, causal=True, **HYBRID_HEADS),
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "max_abs_err": err}
        errs["splitmax_attention"] = max(errs.get("splitmax_attention", 0),
                                         err)
        print(f"[hybrid-kernels] {key} {hq}/{hkv} d{d} causal: == exact "
              f"oracle, max_abs_err {err:.3g} (tol {tol:.3g}), plain "
              f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")

    s_max = SERVE["prompt_len"] + SERVE["gen"] + 8
    lens = torch.randint(SERVE["prompt_len"] + 1,
                         SERVE["prompt_len"] + SERVE["gen"] + 1, (b,),
                         generator=gen, device=dev).tolist()
    args = dense_case(torch, gen, dev, lcfg, exp_lut, recip_lut, lens, hq,
                      hkv, s_max, d)
    q, k, v, m_z, s_q, s_v, lens_t, el, rl = args
    cargs = [qlib.quantize(q, s_q[:, None, None]), k, v, m_z, s_v, lens_t,
             el, rl]
    kp, vp, table = dense_to_pool(torch, gen, k, v, KD.DENSE_BLOCK_K)
    paged = KD.splitmax_decode_fused_paged_cuda(q, kp, vp, table, m_z, s_q,
                                                s_v, lens_t, el, rl, cfg=lcfg)
    outs = {}
    for name, kern, plain, a, q_bytes in (
            ("splitmax_decode_fused", KD.splitmax_decode_fused_cuda,
             KD.splitmax_decode_fused_plain, args, 4),
            ("splitmax_decode", KD.splitmax_decode_cuda,
             KD.splitmax_decode_plain, cargs, 1)):
        ker = kern(*a, cfg=lcfg)
        exact = plain(*a, cfg=lcfg, exact=True)
        default = plain(*a, cfg=lcfg)
        torch.cuda.synchronize()
        err, tol = float((ker - default).abs().max()), tolerance(float(s_v))
        check(torch.equal(ker, exact), f"zamba2 {name} D {d}: kernel != the "
              f"exact=True plain version")
        check(err <= tol, f"zamba2 {name} D {d}: max|kernel-plain| "
              f"{err:.3g} > {tol:.3g}")
        outs[name] = ker
        key = f"{name} dense"
        fns[key] = lambda f=kern, a=a: f(*a, cfg=lcfg)
        plain_ms = time_ms(torch, lambda f=plain, a=a: f(*a, cfg=lcfg),
                           iters=10)
        bms, by = bound_ms(dense_decode_bytes(b, hq, hkv, d, lens, q_bytes,
                                              lcfg), sum(lens) * hq * 6 * d)
        entries[key] = {"shape": dict(b=b, s_max=s_max, lens=lens,
                                      **HYBRID_HEADS),
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "max_abs_err": err}
        errs[name] = err
        print(f"[hybrid-kernels] {name} over the dense cache B {b} x S_max "
              f"{s_max}, {hq}/{hkv} d{d}, lens {lens}: == exact oracle, "
              f"max_abs_err {err:.3g} (tol {tol:.3g}), plain {plain_ms:.4f} "
              f"ms, bound {bms:.5f} ms ({by})")
    check(torch.equal(outs["splitmax_decode"], outs["splitmax_decode_fused"])
          and torch.equal(outs["splitmax_decode_fused"], paged),
          f"zamba2 D {d}: composed, fused and paged decodes differ")
    fns["dense sdpa"] = sdpa_decode_yardstick(torch, F, gen, dev, b, hq, d,
                                              [[n] for n in lens])
    one = torch.zeros(1, device=dev)
    fns["launch floor"] = lambda: one.add_(1)
    times = graph_rounds(torch, fns)
    floor = times.pop("launch floor")[0]
    for key, e in entries.items():
        yard = f"{key} sdpa" if key.startswith("prefill") else "dense sdpa"
        e["ms"], lo, hi = times[key]
        e["ms_range"] = [lo, hi]
        e["library_ms"] = times[yard][0]
        e["launch_floor_ms"] = floor
        print(f"[hybrid-kernels] {key}: kernel {e['ms']:.5f} ms ({lo:.5f}-"
              f"{hi:.5f}), bound {e['bound_ms']:.5f} ms ({e['bound_by']}), "
              f"SDPA bf16 {e['library_ms']:.5f} ms, launch floor "
              f"{floor:.5f} ms")
    subs = {"splitmax_attention": {k: v for k, v in entries.items()
                                   if k.startswith("prefill")},
            "splitmax_decode_fused": entries["splitmax_decode_fused dense"],
            "splitmax_decode": entries["splitmax_decode dense"]}
    return subs, errs


def hybrid_full_phase(torch, F, dev):
    """Zamba2-2.7B at full width on the card (bf16, the tied f32 table is
    the LM head): the churn through ``serve_dense`` with its warm-up, fused
    (kernels 1 and 4) and composed (kernels 1 and 6; the fused churn's
    tokens), each kernel's launches counted (9 shared-attention calls a
    prefill and a step), one profiled batch, and the kernels at its D 80
    shapes (:func:`hybrid_kernel_shapes`).  Returns the launches and the
    kernels' sub-entries and errors."""
    from repro_torch.kernels import splitmax_attn, splitmax_decode as K
    from repro_torch.launch import serve as srv

    t_phase = time.perf_counter()
    cfg, params = init_full(torch, dev, HYBRID_ARCH, "hybrid")
    name = cfg.name
    calls = cfg.n_layers // cfg.hybrid_attn_every
    prompts, gens = churn(cfg)
    kw = dict(slots=SERVE["slots"], gen=SERVE["gen"], gens=gens)
    runs = {}
    for fused in (True, False):
        c = cfg.replace(attn_fused=fused)
        splitmax_attn.launches = 0
        K.launches = K.dense_launches = K.dense_composed_launches = 0
        torch.cuda.reset_peak_memory_stats()
        stats = srv.serve_dense(params, c, prompts, warmup=True, **kw)
        torch.cuda.synchronize()
        n = (splitmax_attn.launches, K.dense_launches,
             K.dense_composed_launches, K.launches)
        what = f"{name} dense churn (fused={fused})"
        check_served(stats, gens, cfg.vocab_size, what, overshoot=1)
        n_dec = n[1] if fused else n[2]
        # the warm-up: the first prefill, a re-prefill and one decode step
        check(n[0] == (stats["batch_prefills"] + 2) * calls,
              f"{what}: prefill launches {n[0]} != ({stats['batch_prefills']} "
              f"batch prefills + 2 warm-up) x {calls}")
        check(n_dec == (stats["decode_steps"] + 1) * calls
              and n[1] + n[2] == n_dec and n[3] == 0,
              f"{what}: dense decode launches {n[1:3]} (paged {n[3]}) != "
              f"({stats['decode_steps']} steps + 1 warm-up) x {calls}")
        runs[fused] = (stats, n[0], n_dec)
        print(f"[hybrid] {what}: {served_line(stats, torch)}, "
              f"{stats['batch_prefills']} batch prefills, launches prefill "
              f"{n[0]} dense decode {n_dec} (warm-up included)")
    check(runs[False][0]["finished"] == runs[True][0]["finished"],
          f"{name}: composed tokens differ from the fused churn's")
    print(f"[hybrid] {name}: composed tokens == fused tokens")
    profile_serving(torch, srv, params, cfg, prompts[:SERVE["slots"]],
                    cache_kind="dense")
    del params
    torch.cuda.empty_cache()
    subs, errs = hybrid_kernel_shapes(torch, F, dev)
    print(f"[hybrid] {name} phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s")
    return ({"splitmax_attention": runs[True][1],
             "splitmax_decode_fused": runs[True][2],
             "splitmax_decode": runs[False][2]}, subs, errs)


# ------------------------------------- int8 serve weights, CIM, baselines --

def int8_smoke_check(torch, dev) -> None:
    """Int8 serve weights at the smoke size in f32: each of
    ``INT8_SMOKE_ARCHS`` drawn on the CPU by a serving init with
    ``serve_param_dtype="int8"`` and served on the card and on the CPU
    from the same weights (a 6-request churn; SeamlessM4T with 24 frames a
    request, Zamba2 through the dense cache): equal tokens.  Then
    Falcon-Mamba's Mamba-1 layers refused on the card, by the serving init
    and by ``serve`` given quantized weights (``ValueError``)."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core import quantization as qlib
    from repro_torch.launch import serve as srv
    from repro_torch.models import encdec as E
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    # the dequantization itself, in place in the compute dtype: the card's
    # bits are the CPU's (bf16: one rounding of the f32 product)
    w = torch.randn((2048, 5632), generator=torch.Generator().manual_seed(5))
    q, s = qlib.quantize_weight(w)
    for dt in (torch.bfloat16, torch.float32):
        on_card = L.linear_weight({"w_q": q.to(dev), "w_s": s.to(dev)}, dt)
        check(torch.equal(on_card.cpu(), L.linear_weight(
            {"w_q": q, "w_s": s}, dt)), f"int8 dequant to {dt}: card != CPU")
    print("[int8-smoke] dequant of a 2048 x 5632 int8 weight to bf16 and "
          "f32: card == CPU bit for bit")
    for arch in INT8_SMOKE_ARCHS:
        cfg = get_arch(arch).smoke.replace(dtype="float32",
                                           serve_param_dtype="int8")
        init = E.init_params if cfg.family == "encdec" else T.init_params
        params = init(cfg, seed=0, device=cpu, serving=True)
        n_int8 = sum(x.dtype == torch.int8 for x in tree_leaves(params))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, 24, dtype=np.int32)
                   for _ in range(6)]
        gens = [int(g) for g in rng.integers(8, 17, 6)]
        kw = dict(slots=3, gen=16, gens=gens, block_k=8)
        if cfg.family == "encdec":
            kw["frames"] = [np.asarray(rng.normal(size=(24, cfg.d_model)),
                                       np.float32) * 0.02 for _ in range(6)]
        if cfg.family == "hybrid":
            kw["cache_kind"] = "dense"
        on_card = srv.serve(tree_to(params, dev), cfg, prompts, **kw)
        on_cpu = srv.serve(params, cfg, prompts, **kw)
        what = f"{arch} int8 smoke churn"
        check_served(on_card, gens, cfg.vocab_size, what,
                     overshoot=int(cfg.family == "hybrid"))
        check(n_int8 > 0 and on_card["finished"] == on_cpu["finished"],
              f"{what}: card tokens differ from the CPU's ({n_int8} int8 "
              f"leaves)")
        print(f"[int8-smoke] {cfg.name} (f32 compute, {n_int8} int8 weight "
              f"leaves), 6-request churn "
              f"({kw.get('cache_kind', 'paged')}): card tokens == CPU tokens")
    cfg = get_arch(SSM_ARCH).smoke.replace(dtype="float32")
    masters = T.init_params(cfg, seed=0, device=dev)
    prompt = [np.arange(8, dtype=np.int32)]
    refusals = {
        "serving init": lambda: T.init_params(
            cfg.replace(serve_param_dtype="int8"), device=dev, serving=True),
        "serve": lambda: srv.serve(
            qlib.quantize_weights_for_serving(masters), cfg, prompt, slots=1,
            gen=2)}
    for what, call in refusals.items():
        try:
            call()
        except ValueError as e:
            check(cfg.family in str(e), f"{cfg.name} int8 {what}: the "
                  f"refusal does not name the family: {e}")
            print(f"[int8-smoke] {cfg.name} int8 {what} refused: {e}")
        else:
            check(False, f"{cfg.name}: int8 {what} of Mamba-1 layers ran")


def decode_baselines_check(torch, dev) -> None:
    """The decode attention's float and fakequant baselines
    (``serve_attn_mode``) on TinyLlama's smoke config in f32, the card vs
    the CPU, same weights: paged prefill + 8 decode steps within
    ``DECODE_BASELINE_TOL`` of the logits' scale, and a 6-request churn's
    tokens equal.  No split-softmax kernel runs in these modes."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.kernels import splitmax_attn, splitmax_decode as K
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    base = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    params = T.init_params(base, seed=0, device=cpu)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, base.vocab_size, (1, 20))
    prompts = [rng.integers(0, base.vocab_size, 24, dtype=np.int32)
               for _ in range(6)]
    gens = [int(g) for g in rng.integers(8, 17, 6)]
    kw = dict(slots=3, gen=16, gens=gens, block_k=8)
    for mode in ("float", "fakequant"):
        cfg = base.replace(serve_attn_mode=mode)
        splitmax_attn.launches = K.launches = 0
        gpu = smoke_paged_logits(torch, params, cfg, tokens, dev)
        on_card = srv.serve_paged(tree_to(params, dev), cfg, prompts, **kw)
        torch.cuda.synchronize()
        n_kernels = splitmax_attn.launches + K.launches
        ref = smoke_paged_logits(torch, params, cfg, tokens, cpu)
        on_cpu = srv.serve_paged(params, cfg, prompts, **kw)
        err = float((gpu - ref).abs().max())
        scale = float(ref.abs().max())
        what = f"{mode} decode baseline"
        check(bool(torch.isfinite(gpu).all()), f"{what}: non-finite")
        check(err <= DECODE_BASELINE_TOL * scale, f"{what}: max|gpu-cpu| "
              f"logits {err:.3g} > {DECODE_BASELINE_TOL} * {scale:.3g}")
        check_served(on_card, gens, base.vocab_size, what)
        check(on_card["finished"] == on_cpu["finished"],
              f"{what}: card tokens differ from the CPU's")
        check(n_kernels == 0, f"{what}: {n_kernels} split-softmax launches")
        print(f"[baselines] {base.name} serve_attn_mode={mode!r}: prefill + "
              f"8 decode steps max|logit diff| card vs CPU {err:.3g} of "
              f"{scale:.3g} (tol {DECODE_BASELINE_TOL} of the scale); "
              f"6-request churn tokens == CPU tokens; 0 split-softmax "
              f"launches")


def deepseek_kernel_shapes(torch, F, dev):
    """Kernels 1, 2, 5 and 3 at DeepSeek-67B's 64/8 heads of D 128 (GQA
    group 8): kernel 1 at its B 1 x 250 admission, kernels 2 and 5 over an
    8-slot pool of block_k 32 at the int8 churn's lengths (251..266), and
    kernel 3 at gamma 4 and gamma 8 over the same pool; each bit for bit
    its ``exact=True`` plain version and within ``tolerance`` of the
    default one, kernel 5 also bit for bit kernel 2 on ``quantize(q,
    s_q)``; each timed by graph replay beside its bound and SDPA's bf16
    kernel.  Returns each kernel's sub-entry (``"deepseek67b"``) and its
    largest error."""
    from repro_torch.core import paged_kv
    from repro_torch.core import quantization as qlib
    from repro_torch.core.attention import luts_for
    from repro_torch.core.lut import LUTConfig
    from repro_torch.kernels import ops, splitmax_attn as KA
    from repro_torch.kernels import splitmax_decode as KD

    lcfg = LUTConfig(scale_z=8.0 / 127)
    exp_lut, recip_lut = luts_for(lcfg.scale_z, dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    hq, hkv, d = (DS_HEADS[k] for k in ("hq", "hkv", "d"))
    b, bk, s = SERVE["slots"], SERVE["block_k"], SERVE["prompt_len"]
    luts = 4 * (256 + lcfg.recip_table_size)
    fns, entries, errs = {}, {}, {}

    def held(name, ker, exact, default, s_v, what):
        torch.cuda.synchronize()
        err, tol = float((ker - default).abs().max()), tolerance(float(s_v))
        check(torch.equal(ker, exact), f"deepseek67b {what}: kernel != the "
              f"exact=True plain version")
        check(err <= tol, f"deepseek67b {what}: max|kernel-plain| {err:.3g} "
              f"> {tol:.3g}")
        errs[name] = max(errs.get(name, 0.0), err)
        return err

    # kernel 1: one admission
    q = torch.randn((1, hq, s, d), generator=gen, device=dev)
    k = torch.randn((1, hkv, s, d), generator=gen, device=dev)
    v = torch.randn((1, hkv, s, d), generator=gen, device=dev)
    s_q, s_k, s_v = (qlib.absmax_scale(x) for x in (q, k, v))
    args = (qlib.quantize(q, s_q), qlib.quantize(k, s_k),
            qlib.quantize(v, s_v),
            ops.requant_multiplier(s_q, s_k, d, lcfg).reshape(()), s_v,
            exp_lut, recip_lut)
    kw = dict(cfg=lcfg)
    err = held("splitmax_attention", KA.splitmax_attention_cuda(*args, **kw),
               KA.splitmax_attention_plain(*args, exact=True, **kw),
               KA.splitmax_attention_plain(*args, **kw), s_v,
               f"prefill B 1 x {s}")
    fns["prefill"] = lambda: KA.splitmax_attention_cuda(*args, **kw)
    kb, vb = (x.to(torch.bfloat16).repeat_interleave(hq // hkv, dim=1)
              for x in (k, v))
    qb = q.to(torch.bfloat16)
    fns["prefill sdpa"] = lambda: F.scaled_dot_product_attention(
        qb, kb, vb, is_causal=True)
    bms, by = bound_ms(hq * s * d + 2 * hkv * s * d + 4 * hq * s * d + luts,
                       hq * s * (s + 1) // 2 * 6 * d)
    entries["prefill"] = {
        "shape": dict(b=1, s=s, causal=True, **DS_HEADS), "bound_ms": bms,
        "bound_by": by, "max_abs_err": err,
        "plain_ms": time_ms(torch, lambda: KA.splitmax_attention_plain(
            *args, **kw), iters=3, warm=1)}

    # kernels 2 and 5 over the pool
    lens = torch.randint(s + 1, s + DS_CHURN["gen"] + 1, (b,), generator=gen,
                         device=dev).tolist()
    kp, vp, table, lens_t = paged_case(torch, gen, dev, lens, hkv, d, bk)
    s_k, s_v = pool_scales(torch, dev)
    q = torch.randn((b, hq, d), generator=gen, device=dev)
    s_q = qlib.absmax_scale(q, axis=(1, 2)).reshape(-1)
    m_z = ops.requant_multiplier(s_q, s_k, d, lcfg)
    dargs = [q, kp, vp, table, m_z, s_q, s_v, lens_t, exp_lut, recip_lut]
    cargs = [qlib.quantize(q, s_q[:, None, None]), kp, vp, table, m_z, s_v,
             lens_t, exp_lut, recip_lut]
    fused = KD.splitmax_decode_fused_paged_cuda(*dargs, cfg=lcfg)
    composed = KD.splitmax_decode_paged_cuda(*cargs, cfg=lcfg)
    check(torch.equal(fused, composed), "deepseek67b: the composed decode "
          "differs from the fused one on quantize(q, s_q)")
    tiles = sum(paged_kv.blocks_per_seq(n, bk) for n in lens)
    for key, name, kern, plain, a, q_bytes in (
            ("decode", "splitmax_decode_fused_paged",
             KD.splitmax_decode_fused_paged_cuda,
             KD.splitmax_decode_fused_paged_plain, dargs, 4),
            ("composed", "splitmax_decode_paged",
             KD.splitmax_decode_paged_cuda, KD.splitmax_decode_paged_plain,
             cargs, 1)):
        err = held(name, kern(*a, cfg=lcfg), plain(*a, cfg=lcfg, exact=True),
                   plain(*a, cfg=lcfg), s_v, f"{key} lens {lens}")
        fns[key] = lambda f=kern, a=a: f(*a, cfg=lcfg)
        bms, by = bound_ms(q_bytes * b * hq * d + 2 * hkv * d * sum(lens)
                           + 4 * tiles + 4 * b * 3 + 4 * b * hq * d + luts,
                           sum(lens) * hq * 6 * d)
        entries[key] = {
            "shape": dict(b=b, lens=lens, block_k=bk, **DS_HEADS),
            "bound_ms": bms, "bound_by": by, "max_abs_err": err,
            "plain_ms": time_ms(torch, lambda f=plain, a=a: f(*a, cfg=lcfg),
                                iters=10)}
    fns["decode sdpa"] = sdpa_decode_yardstick(torch, F, gen, dev, b, hq, d,
                                               [[n] for n in lens])

    # kernel 3: gamma 4 (the served gamma) and 8, over the same pool
    for gamma in (SPEC["gamma"], 2 * SPEC["gamma"]):
        key = f"verify gamma {gamma}"
        qv = torch.randn((b, hq, gamma, d), generator=gen, device=dev)
        s_qv = qlib.absmax_scale(qv, axis=(1, 3))[:, 0, :, 0].contiguous()
        vargs = [qv, kp, vp, table, ops.requant_multiplier(s_qv, s_k, d, lcfg),
                 s_qv, s_v, lens_t, exp_lut, recip_lut]
        err = held("splitmax_decode_fused_verify_paged",
                   KD.splitmax_decode_fused_verify_paged_cuda(*vargs,
                                                              cfg=lcfg),
                   KD.splitmax_decode_fused_verify_paged_plain(
                       *vargs, cfg=lcfg, exact=True),
                   KD.splitmax_decode_fused_verify_paged_plain(*vargs,
                                                               cfg=lcfg),
                   s_v, key)
        fns[key] = (lambda a=vargs:
                    KD.splitmax_decode_fused_verify_paged_cuda(*a, cfg=lcfg))
        q_lens = [[n - (gamma - 1 - t) for t in range(gamma)] for n in lens]
        fns[f"{key} sdpa"] = sdpa_decode_yardstick(torch, F, gen, dev, b, hq,
                                                   d, q_lens)
        bms, by = bound_ms(8 * b * hq * gamma * d + 2 * hkv * d * sum(lens)
                           + 4 * tiles + 4 * b + 8 * b * gamma + 4 + luts,
                           hq * sum(map(sum, q_lens)) * 6 * d)
        entries[key] = {
            "shape": dict(b=b, lens=lens, gamma=gamma, block_k=bk,
                          **DS_HEADS),
            "bound_ms": bms, "bound_by": by, "max_abs_err": err,
            "plain_ms": time_ms(
                torch, lambda a=vargs:
                KD.splitmax_decode_fused_verify_paged_plain(*a, cfg=lcfg),
                iters=3, warm=1)}
    one = torch.zeros(1, device=dev)
    fns["launch floor"] = lambda: one.add_(1)
    times = graph_rounds(torch, fns)
    floor = times.pop("launch floor")[0]
    for key, e in entries.items():
        yard = key if key.startswith(("prefill", "verify")) else "decode"
        e["ms"], lo, hi = times[key]
        e["ms_range"] = [lo, hi]
        e["library_ms"] = times[f"{yard} sdpa"][0]
        e["launch_floor_ms"] = floor
        print(f"[ds67b-kernels] {key} {hq}/{hkv} d{d} {e['shape']}: == exact "
              f"oracle, max_abs_err {e['max_abs_err']:.3g}; kernel "
              f"{e['ms']:.5f} ms ({lo:.5f}-{hi:.5f}), bound "
              f"{e['bound_ms']:.5f} ms ({e['bound_by']}), plain "
              f"{e['plain_ms']:.4f} ms, SDPA bf16 {e['library_ms']:.5f} ms, "
              f"launch floor {floor:.5f} ms")
    subs = {"splitmax_attention": entries["prefill"],
            "splitmax_decode_fused_paged": entries["decode"],
            "splitmax_decode_paged": entries["composed"],
            "splitmax_decode_fused_verify_paged": {
                k: v for k, v in entries.items() if k.startswith("verify")}}
    return subs, errs


def cim_phase(torch, dev):
    """The CIM datapath model (``core/cim.py``) through kernel 8 at one
    DeepSeek-67B MLP shape (``CIM_SHAPE``: x (M, K) @ w_in (K, N)): the
    nibble-split product (2 body launches, each on its own pre-pass) and
    the 8-cycle bit-serial one (8 body launches on one pre-pass), counted
    from 0, each bit for bit kernel 8's direct product and its plain
    version's; then the Q15 requant pipeline on the card bit for bit the
    CPU's.  Timed host-inclusive beside the direct product, the plain
    version and ``torch._int_mm``.  Returns kernel 8's ``"cim"``
    sub-entry."""
    from repro_torch.core import cim
    from repro_torch.core import quantization as qlib
    from repro_torch.kernels import int8_matmul as K8

    m, k, n = CIM_SHAPE
    gen = torch.Generator(device=dev).manual_seed(21)
    x = int8_like(torch, gen, (m, k), dev)
    w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    K8.launches = K8.pack_launches = 0
    nib = cim.nibble_split_matmul(x, w)
    torch.cuda.synchronize()
    by_path = {"cim nibble split": (K8.launches, K8.pack_launches)}
    K8.launches = K8.pack_launches = 0
    ser = cim.serial_bit_matmul(x, w)
    torch.cuda.synchronize()
    by_path["cim bit-serial"] = (K8.launches, K8.pack_launches)
    check(by_path == {"cim nibble split": (2, 2), "cim bit-serial": (8, 1)},
          f"CIM kernel 8 launches (body, pre-pass) {by_path}, want "
          f"(2, 2) and (8, 1)")
    direct = K8.int8_matmul_cuda(x, w)
    plain = K8.int8_matmul_plain(x, w)
    for what, got in (("nibble split", nib), ("bit-serial", ser)):
        check(torch.equal(got, direct) and torch.equal(got, plain),
              f"CIM {what}: differs from kernel 8's direct product or its "
              f"plain version's")
    requant = {}
    for mult in CIM_REQUANT_MULTIPLIERS:
        on_card = qlib.requantize_int32_bitexact(direct, mult)
        on_cpu = qlib.requantize_int32_bitexact(direct.cpu(), mult)
        check(torch.equal(on_card.cpu(), on_cpu), f"requantize_int32_bitexact "
              f"(m {mult}): card != CPU")
        ideal = qlib.requantize_int32(direct, torch.tensor(mult, device=dev))
        requant[mult] = int((ideal.int() - on_card.int()).abs().max())
        check(requant[mult] <= 1, f"requant m {mult}: {requant[mult]} LSB "
              f"from the float requant")
    times = {"nibble_split_ms": lambda: cim.nibble_split_matmul(x, w),
             "serial_bit_ms": lambda: cim.serial_bit_matmul(x, w),
             "direct_ms": lambda: K8.int8_matmul_cuda(x, w),
             "plain_ms": lambda: K8.int8_matmul_plain(x, w),
             "library_ms": lambda: torch._int_mm(x, w),
             "requant_bitexact_ms":
                 lambda: qlib.requantize_int32_bitexact(direct, 0.0117)}
    out = {key: time_ms(torch, fn, iters=5, warm=2)
           for key, fn in times.items()}
    bms, by = bound_ms(m * k + k * n + 4 * m * n, 2 * m * k * n)
    out.update(shape=[m, k, n], bound_ms=bms, bound_by=by,
               launches_by_path={p: v[0] for p, v in by_path.items()},
               pre_pass_launches_by_path={p: v[1] for p, v in by_path.items()},
               requant_max_lsb_from_float=requant, exact_equal=True)
    print(f"[cim] x ({m}, {k}) @ w ({k}, {n}) int8: nibble split (2 kernel-8 "
          f"launches) and bit-serial (8 on one pre-pass) == kernel 8's direct "
          f"product == its plain version, bit for bit; requant pipeline card "
          f"== CPU, within {max(requant.values())} LSB of the float requant; "
          f"host-inclusive ms: nibble {out['nibble_split_ms']:.4f}, "
          f"bit-serial {out['serial_bit_ms']:.4f}, direct "
          f"{out['direct_ms']:.4f}, plain f64 {out['plain_ms']:.4f}, "
          f"torch._int_mm {out['library_ms']:.4f}, requant "
          f"{out['requant_bitexact_ms']:.4f}; bound {bms:.5f} ms ({by})")
    return out


def tinyllama_int8_vs_bf16(torch, dev) -> None:
    """TinyLlama-1.1B at full width on the serving churn (SERVE: 24
    requests, 8 slots, gens 16..32), with bf16 and with int8 serve weights
    from the same seed, both resident: each served with its warm-up in
    ``INT8_VS_BF16_ORDER`` (interleaved, so that a drift of the shared
    host falls on both).  Prints every run's tok/s and p50 step, each
    dtype's median and spread, and the int8 / bf16 ratio of the medians,
    called unresolved where a spread exceeds the gap.  A record of the
    dequantization's cost, not a target; each dtype's tokens repeat bit
    for bit."""
    import statistics

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    base = get_arch("tinyllama_1p1b").config
    prompts, gens = churn(base)
    kw = dict(slots=SERVE["slots"], gen=SERVE["gen"], gens=gens,
              block_k=SERVE["block_k"])
    models = {}
    for dtype in ("bfloat16", "int8"):
        cfg = base.replace(serve_param_dtype=dtype)
        params = T.init_params(cfg, seed=SERVE["seed"], device=dev,
                               serving=True)
        w_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(params))
        models[dtype] = (cfg, params, w_bytes)
    runs = {"bfloat16": [], "int8": []}
    tokens = {}
    for i, dtype in enumerate(INT8_VS_BF16_ORDER):
        cfg, params, w_bytes = models[dtype]
        stats = srv.serve_paged(params, cfg, prompts, warmup=True, **kw)
        torch.cuda.synchronize()
        check_served(stats, gens, cfg.vocab_size, f"{cfg.name} {dtype}")
        check(tokens.setdefault(dtype, stats["finished"])
              == stats["finished"],
              f"{cfg.name} {dtype}: run {i} tokens differ from its first")
        runs[dtype].append(stats)
        print(f"[int8-vs-bf16] run {i} {cfg.name} {dtype} weights "
              f"({w_bytes / 1e9:.2f} GB): {served_line(stats, torch)}")
    del models
    torch.cuda.empty_cache()

    def summary(key):
        """Each dtype's median of ``key`` and its spread (max - min over
        the median), and the int8 / bf16 ratio of the medians."""
        med, spread = {}, {}
        for dtype, rs in runs.items():
            xs = [r[key] for r in rs]
            med[dtype] = statistics.median(xs)
            spread[dtype] = (max(xs) - min(xs)) / med[dtype]
        ratio = med["int8"] / med["bfloat16"]
        verdict = ("resolved" if abs(ratio - 1) > max(spread.values())
                   else "unresolved: a spread exceeds the gap")
        return (f"{key} int8 / bf16 {ratio:.3f} (medians {med['int8']:.2f} "
                f"/ {med['bfloat16']:.2f} of {len(runs['int8'])} runs each; "
                f"spread int8 {100 * spread['int8']:.1f}%, bf16 "
                f"{100 * spread['bfloat16']:.1f}%, gap "
                f"{100 * abs(ratio - 1):.1f}%): {verdict}")

    print(f"[int8-vs-bf16] {summary('tok_s')}")
    print(f"[int8-vs-bf16] {summary('p50_step_ms')}")


# ------------------------------------------- mesh, roofline and dry-run --

_CARD_TERMS = """
import json, sys
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.dryrun import dryrun_cell
out = {}
for name, kind, seq, batch in json.loads(sys.argv[1]):
    out[name] = dryrun_cell("tinyllama_1p1b", name, multi_pod=False,
                            mesh=((1, 1), ("data", "model")),
                            cell=ShapeCell(name, seq, batch, kind),
                            verbose=False)
print("TERMS" + json.dumps(out))
"""


def start_dryruns(src: Path):
    """Start the CPU-side work of phase 13 in child processes, to run while
    the card's phases do: the dry-run CLI on ``DRYRUN_CELL`` then
    ``launch.report`` on its output, and the roofline counts of
    ``CARD_CELLS``.  Returns the processes by name; at exit each still
    running is killed and their directory removed."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=str(src))
    arch, shape = DRYRUN_CELL
    out = os.path.join(tmp, "dryrun.json")
    cli = (f"{sys.executable} -m repro_torch.launch.dryrun --arch {arch} "
           f"--shape {shape} --mesh single --out {out} && "
           f"{sys.executable} -m repro_torch.launch.report {out}")
    procs = {
        "dryrun": subprocess.Popen(["bash", "-c", cli], env=env,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True),
        "terms": subprocess.Popen(
            [sys.executable, "-c", _CARD_TERMS, json.dumps(CARD_CELLS)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)}
    def stop():
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return procs


def _finish(proc, what: str, timeout: float = 600) -> str:
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise SmokeFailure(f"{what}: no exit in {timeout} s")
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}:\n"
          f"{out[-3000:]}")
    return out


def mesh_roofline_phase(torch, dev, procs, serve_p50_ms: float) -> None:
    """Phase 13: ``launch.train.main`` at full TinyLlama width, B 4 x 2048,
    3 steps, unbound and then on a (1, 1) ``DeviceMesh`` over the card
    (``--mesh single --mesh-shape 1x1``: NCCL, world 1; parameters and
    moments placed by ``param_shardings``, the step under ``axis_rules``):
    losses, grad norms, parameters and moments bit for bit.  Then each
    measured step against its roofline terms (the dry-run's counts at the
    data sheet's constants): a step shorter than its compute term fails
    (a wrong flop count); the memory term's ratio is only printed (its
    byte count is unfused).  The same for the decode step beside the
    serve churn's p50 step.  Last, the dry-run CLI's exit and its
    report's one row."""
    import statistics
    from repro_torch import tree as tu
    from repro_torch.launch import train
    from repro_torch.launch.roofline import measured_mfu

    t = MESH_TRAIN
    argv = ["--device", "cuda", "--steps", str(t["steps"]), "--warmup",
            str(t["warmup"]), "--batch", str(t["batch"]), "--seq",
            str(t["seq"]), "--seed", str(t["seed"]), "--log-every", "1"]
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    launcher = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                    RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    t0 = time.perf_counter()
    plain = train.main(argv)
    old = {k: os.environ.get(k) for k in launcher}
    os.environ.update(launcher)
    try:
        meshed = train.main(argv + ["--mesh", "single", "--mesh-shape",
                                    "1x1"])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    import torch.distributed as dist
    check(not dist.is_initialized(), "the mesh run left a process group")
    for key in ("losses", "ce", "grad_norms", "lrs"):
        check(meshed[key] == plain[key], f"(1, 1) mesh {key} "
              f"{meshed[key]} != unbound {plain[key]}")
    n = 0
    for tree in ("params", "opt_state"):
        for a, b in zip(tu.leaves(meshed[tree]), tu.leaves(plain[tree])):
            a = a.full_tensor() if hasattr(a, "full_tensor") else a
            check(torch.equal(a, b), f"(1, 1) mesh {tree} leaf {n} differs")
            n += 1
    placed = sum(hasattr(a, "device_mesh")
                 for a in tu.leaves(meshed["params"]))
    step_s = {"unbound": statistics.median(plain["step_s"][1:]),
              "(1, 1) mesh": statistics.median(meshed["step_s"][1:])}
    print(f"[mesh] {meshed['cfg'].name} full width, B {t['batch']} x "
          f"{t['seq']}, {t['steps']} steps on a (1, 1) DeviceMesh "
          f"{meshed['mesh'].mesh_dim_names} (NCCL, world 1; {placed} "
          f"DTensor parameters): losses {meshed['losses']}, grad norms, "
          f"{n} parameter and moment leaves bit for bit the unbound run's; "
          f"step {step_s['unbound'] * 1e3:.1f} ms unbound, "
          f"{step_s['(1, 1) mesh'] * 1e3:.1f} ms on the mesh (median of "
          f"steps 2-{t['steps']}); {time.perf_counter() - t0:.1f} s")
    del plain, meshed
    # a train step leaves reference cycles (its frames, through the
    # checkpointed blocks) that hold the states until the collector runs:
    # collect them now, before phase 8 measures its init peak
    gc.collect()
    torch.cuda.empty_cache()

    out = _finish(procs["terms"], "roofline counts")
    terms = json.loads(next(x for x in out.splitlines()
                            if x.startswith("TERMS"))[len("TERMS"):])
    measured = {"card train": step_s, "card decode":
                {"serve churn p50": serve_p50_ms / 1e3}}
    for name, kind, seq, batch in CARD_CELLS:
        r = terms[name]["roofline"]
        for what, sec in measured[name].items():
            check(sec >= r["t_compute_s"], f"{name}: measured {what} step "
                  f"{sec * 1e3:.3f} ms < its compute term "
                  f"{r['t_compute_s'] * 1e3:.3f} ms: a wrong flop count")
            print(f"[roofline] {name} (B {batch} x {seq}, {kind}) {what}: "
                  f"measured {sec * 1e3:.3f} ms; t_compute "
                  f"{r['t_compute_s'] * 1e3:.3f} ms, t_memory (unfused) "
                  f"{r['t_memory_s'] * 1e3:.3f} ms, t_collective "
                  f"{r['t_collective_s'] * 1e3:.3f} ms -> "
                  f"{r['bottleneck']}; roofline MFU "
                  f"{100 * r['roofline_mfu']:.2f}%, measured MFU "
                  f"{100 * measured_mfu(r['model_flops'], sec):.2f}%; "
                  f"measured / t_compute {sec / r['t_compute_s']:.2f}, "
                  f"measured / t_memory {sec / r['t_memory_s']:.3f}")

    out = _finish(procs["dryrun"], "the dry-run CLI and its report")
    rows = [x for x in out.splitlines() if x.startswith(
        f"| {DRYRUN_CELL[0]} | {DRYRUN_CELL[1]} |")]
    check(len(rows) == 1, f"the dry-run report has {len(rows)} rows "
          f"for {DRYRUN_CELL}:\n{out[-2000:]}")
    print(f"[dryrun] {' x '.join(DRYRUN_CELL)} x 16x16 (CLI and "
          f"launch.report, exit 0): {rows[0]}")


_DIRECT_DRYRUN = """
import json, sys
from repro_torch.launch.dryrun import dryrun_cell
print(json.dumps(dryrun_cell(sys.argv[1], sys.argv[2], multi_pod=True,
                             verbose=False), default=float))
"""


def start_example_dryruns(root: Path):
    """Phase 15's CPU-side part, started with phase 13's: the
    ``EXAMPLE_CELL`` multi-pod dry-run through
    ``examples/multi_pod_lower_torch.py`` and through a direct
    ``dryrun_cell`` call, each in a child process (each sets up its own
    ``fake`` process group).  Killed at exit if still running."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    arch, shape = EXAMPLE_CELL
    procs = {
        "example": subprocess.Popen(
            [sys.executable, str(root / "examples" /
                                 "multi_pod_lower_torch.py"),
             "--arch", arch, "--shape", shape], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True),
        "direct": subprocess.Popen(
            [sys.executable, "-c", _DIRECT_DRYRUN, arch, shape], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)}

    def stop():
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()

    atexit.register(stop)
    return procs


def _load_example(root: Path, name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", root / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output kept: (result, lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def examples_phase(torch, dev, procs) -> dict:
    """Phase 15: each of ``examples/*_torch.py`` through its ``main``, in
    this process so that the launch counters see the kernels (reset just
    before each call, read just after).  Returns the examples' launches of
    kernels 1, 2 and 4 by kernel name."""
    import signal
    import threading
    from repro_torch import tree as tu
    from repro_torch.kernels import splitmax_attn
    from repro_torch.kernels import splitmax_decode as K

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    total = {"splitmax_attention": 0, "splitmax_decode_fused_paged": 0,
             "splitmax_decode_fused": 0}

    def counted(fn, *args):
        splitmax_attn.launches = K.launches = K.dense_launches = 0
        K.tile_launches.clear()
        out, lines = _quiet(fn, *args)
        torch.cuda.synchronize()
        n = (splitmax_attn.launches, K.launches, K.dense_launches)
        # nothing is swept here: every dense decode is the default instance
        check(not K.tile_launches, f"{fn.__module__}: tile instances "
              f"launched with an empty sweep cache: {K.tile_launches}")
        for name, k in zip(total, n):
            total[name] += k
        return out, lines, n

    # ---- quickstart: card, CPU, and the README's command ------------------
    qs = _load_example(root, "quickstart_torch")
    n_layers = qs.tiny_config().n_layers
    card, card_lines, n = counted(qs.main, [])
    want = (1 + n_layers, 0, qs.DECODE_STEPS * n_layers)
    check(n == want, f"quickstart: kernel 1, 2, 4 launches {n}, want {want} "
          f"(1 attention, {n_layers} layers' prefill, "
          f"{qs.DECODE_STEPS} x {n_layers} decodes)")
    cpu, cpu_lines = _quiet(qs.main, ["--device", "cpu"])
    for a, b in zip(card_lines, cpu_lines):
        if "LUT" in a or "p_lut" in a:
            check(a == b, f"quickstart LUT line, card {a!r} vs CPU {b!r}")
    check(card["lut"]["lut_bytes"] == cpu["lut"]["lut_bytes"],
          "quickstart: LUT footprints differ")
    drift = max(abs(card["attention"][k] - cpu["attention"][k])
                for k in card["attention"])
    check(drift <= QUICKSTART_DRIFT_TOL, f"quickstart drifts, card "
          f"{card['attention']} vs CPU {cpu['attention']}")
    loss_err = max(abs(a / b - 1) for a, b in zip(card["losses"],
                                                  cpu["losses"]))
    check(all(map(math.isfinite, card["losses"]))
          and loss_err <= QUICKSTART_LOSS_RTOL,
          f"quickstart losses, card {card['losses']} vs CPU {cpu['losses']}")
    check(card["tokens"] == cpu["tokens"], f"quickstart greedy continuation,"
          f" card {card['tokens']} vs CPU {cpu['tokens']}")
    on_cpu, _ = _quiet(qs.int8_decode, tu.tree_map(
        lambda t: t.cpu(), card["params"]), qs.tiny_config(), "cpu",
        card["prompt"])
    check(on_cpu == card["tokens"], f"quickstart: the card's trained weights "
          f"decode to {on_cpu} on the CPU, {card['tokens']} on the card")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "examples/quickstart_torch.py"],
                           cwd=root, env=env, capture_output=True, text=True,
                           timeout=300)
    t_child = time.perf_counter() - t0
    check(child.returncode == 0, f"python examples/quickstart_torch.py: exit "
          f"{child.returncode}\n{child.stderr[-3000:]}")
    check(child.stdout.splitlines()[-1] == card_lines[-1],
          f"quickstart as a command: {child.stdout.splitlines()[-1]!r} vs "
          f"in-process {card_lines[-1]!r}")
    print(f"[examples] quickstart: LUT {card['lut']} equal on the card and "
          f"the CPU; drifts card {card['attention']} CPU {cpu['attention']};"
          f" losses card {card['losses']} CPU {cpu['losses']} (max relative "
          f"difference {loss_err:.3g}); greedy continuation {card['tokens']}"
          f" on both, and from the card's trained weights on the CPU; "
          f"launches kernel 1 {n[0]}, kernel 4 {n[2]}; `python "
          f"examples/quickstart_torch.py` exit 0 in {t_child:.1f} s, its "
          f"last line the in-process run's")

    # ---- serve_batched ------------------------------------------------------
    stats, _, n = counted(_load_example(root, "serve_batched_torch").main, [])
    cfg = qs.tiny_config()
    check_served(stats, [16] * 8, cfg.vocab_size, "serve_batched")
    check(n[0] == stats["slot_prefills"] * cfg.n_layers
          and n[1] == stats["decode_steps"] * cfg.n_layers and n[2] == 0,
          f"serve_batched: launches {n}, want {stats['slot_prefills']} "
          f"admissions and {stats['decode_steps']} steps x {cfg.n_layers}")
    print(f"[examples] serve_batched: served {stats['served']} of 8, "
          f"{stats['total_tokens']} tokens, {stats['leaked_blocks']} leaked "
          f"blocks, {stats['tok_s']:.1f} tok/s, p50 step "
          f"{stats['p50_step_ms']:.2f} ms; launches kernel 1 {n[0]} "
          f"({stats['slot_prefills']} admissions), kernel 2 {n[1]} "
          f"({stats['decode_steps']} steps)")

    # ---- train_lm: SIGTERM, resume, straight; --full --steps 3 ------------
    tl = _load_example(root, "train_lm_torch")
    with tempfile.TemporaryDirectory() as tmp:
        stopped = os.path.join(tmp, "stopped")
        proc = subprocess.Popen(
            [sys.executable, "examples/train_lm_torch.py", "--ckpt-dir",
             stopped], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        guard = threading.Timer(300, proc.kill)
        guard.start()
        sent, seen = False, []
        for line in proc.stdout:
            seen.append(line)
            if not sent and line.startswith(
                    f"step {EXAMPLE_SIGTERM_STEP:5d} loss"):
                proc.send_signal(signal.SIGTERM)
                sent = True
        rc = proc.wait()
        guard.cancel()
        check(sent and rc == 143, f"train_lm: SIGTERM after step "
              f"{EXAMPLE_SIGTERM_STEP}: sent {sent}, exit {rc}\n"
              f"{''.join(seen)[-2000:]}")
        resumed, lines = _quiet(tl.main, ["--ckpt-dir", stopped])
        n_at = resumed["start_step"]
        check(f"resumed from step {n_at}" in lines
              and n_at >= EXAMPLE_SIGTERM_STEP, f"train_lm: the second run "
              f"printed no resume at or after step {EXAMPLE_SIGTERM_STEP}")
        straight, _ = _quiet(tl.main, ["--ckpt-dir",
                                       os.path.join(tmp, "straight")])
        same = (resumed["losses"] == straight["losses"][n_at:]
                and all(torch.equal(a, b) for a, b in zip(
                    tu.leaves((resumed["params"], resumed["opt_state"])),
                    tu.leaves((straight["params"], straight["opt_state"])))))
        check(same, f"train_lm: resumed at {n_at}, final loss "
              f"{resumed['losses'][-1]!r} vs straight "
              f"{straight['losses'][-1]!r}, or parameters/moments differ")
        print(f"[examples] train_lm smoke default: SIGTERM after step "
              f"{EXAMPLE_SIGTERM_STEP}, exit 143; the same command resumed "
              f"from step {n_at} and ended on loss "
              f"{resumed['losses'][-1]!r}, bit for bit the straight run's "
              f"({len(resumed['losses'])} losses from step {n_at + 1} on, "
              f"the final parameters and moments)")
        del resumed, straight
        torch.cuda.reset_peak_memory_stats()
        full, _ = _quiet(tl.main, ["--full", "--steps", "3", "--ckpt-dir", ""])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(full["losses"]) == 3 and all(map(math.isfinite,
                                               full["losses"])),
          f"train_lm --full --steps 3: losses {full['losses']}")
    print(f"[examples] train_lm --full --steps 3 (TinyLlama-1.1B, B 8 x 256,"
          f" no checkpoint): losses {[round(x, 4) for x in full['losses']]}, "
          f"step s {[round(x, 3) for x in full['step_s']]}, peak memory "
          f"{peak:.2f} GiB")
    del full
    gc.collect()
    torch.cuda.empty_cache()

    # ---- accuracy_study: card vs CPU at 20 steps, the default on the card --
    acc = _load_example(root, "accuracy_study_torch")
    a = ACCURACY_CHECK
    steps = ["--steps", str(a["steps"])]
    rows_card, _, n = counted(acc.main, steps)
    rows_cpu, _ = _quiet(acc.main, steps + ["--device", "cpu"])
    rows, _, n_default = counted(acc.main, [])
    for got in (n, n_default):
        check(got == (acc.EVAL_BATCHES * cfg.n_layers, 0, 0),
              f"accuracy_study: launches {got}, want {acc.EVAL_BATCHES} "
              f"batches x {cfg.n_layers} layers of kernel 1")
    cpu_of = {name: val for name, val, _ in rows_cpu}
    for name, val, _ in rows_card:
        want = cpu_of[name]
        if name in ACCURACY_POSITIONS:
            d = round(abs(val - want) * ACCURACY_POSITIONS[name])
            ok = d <= a["positions"]
        elif name == "accuracy.train_loss":
            d = abs(val / want - 1)
            ok = d <= a["train_loss"]
        else:
            d = abs(val - want)
            ok = d <= (a["tv"] if name == "accuracy.next_token_tv"
                       else a["prob_err"])
        check(ok, f"accuracy_study at {a['steps']} steps: {name} card {val!r}"
              f" vs CPU {want!r}")
        print(f"[examples] accuracy {a['steps']} steps {name:24s} card "
              f"{val:.6f} CPU {want:.6f} difference {d:.3g}")
    for name, val, derived in rows:
        print(f"[examples] accuracy 200 steps {name:28s} {val:10.5f}   "
              f"{derived}")

    # ---- multi_pod_lower ----------------------------------------------------
    out = _finish(procs["example"], "multi_pod_lower_torch.py", timeout=300)
    lines = out.splitlines()
    report = json.loads("\n".join(lines[lines.index("{"):]))
    direct = json.loads(_finish(procs["direct"], "dryrun_cell",
                                timeout=300).strip().splitlines()[-1])
    for rep in (report, direct):
        for key in ("lower_s", "compile_s"):
            rep.pop(key)
    check(report == direct, "multi_pod_lower_torch.py's report differs from "
          "dryrun_cell's")
    roof = report["roofline"]
    terms = ("t_compute_s", "t_memory_s", "t_collective_s")
    check(all(roof[t] > 0 for t in terms), f"multi_pod_lower: {roof}")
    print(f"[examples] multi_pod_lower {EXAMPLE_CELL} on {report['mesh']}: "
          f"the report equals dryrun_cell's (host times aside); "
          + ", ".join(f"{t} {roof[t]:.3g}" for t in terms)
          + f", bottleneck {roof['bottleneck']}")
    wall = time.perf_counter() - t_phase
    print(f"[examples] kernel launches: kernel 1 "
          f"{total['splitmax_attention']}, kernel 2 "
          f"{total['splitmax_decode_fused_paged']}, kernel 4 "
          f"{total['splitmax_decode_fused']} (each the default instance: no "
          f"tile instance launched); phase 15 wall time {wall:.1f} s")
    return total


# ------------------------------------------------- phase 16: tile sweep --

# the sweeps of phase 16: (kind, head dim, s_max, gamma, slots, hq, hkv); the
# CLI's own heads (4 / 2) and batch (4) except the wide group-8 verify at
# D 128 (16 / 2 heads), where kernel 3 loses to SDPA (ROADMAP queue 2)
TILE_SWEEPS = (("decode", 64, 2048, None, 4, 4, 2),
               ("decode", 80, 2048, None, 4, 4, 2),
               ("verify", 64, 2048, 4, 4, 4, 2),
               ("verify", 64, 2048, 8, 4, 4, 2),
               ("verify", 128, 2048, 4, 4, 16, 2),
               ("verify", 128, 2048, 8, 4, 16, 2))
TILE_ITERS = 20
# the dense churn served again with its cache at the sweeps' s_max
TILE_CHURN_MAX_LEN = 2048


def autotune_phase(torch, dev) -> dict:
    """Phase 16: the tile sweep (``kernels/autotune.py``) on the card.  The
    CLI for decode and gamma 4 at D 64 x 2048, then the sweeps of
    ``TILE_SWEEPS``, each printing its table; every compiled instance held
    bit for bit against the ``exact=True`` plain version on the sweep's
    inputs; kernel 3's two row paddings timed and held the same way; then
    TinyLlama's dense churn with its cache at 2048, with the swept decode
    winner in the cache and without, tokens equal.  Returns the tables and
    the launches by path."""
    from repro_torch.configs import get_arch
    from repro_torch.core import quantization as qlib
    from repro_torch.kernels import autotune, splitmax_decode as K
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    autotune.clear_sweep_cache()
    K.dense_launches = K.dense_composed_launches = 0
    K.dense_verify_launches = 0
    K.tile_launches.clear()
    tables = {}
    for kind, d, s_max, gamma, b, hq, hkv in TILE_SWEEPS:
        label = (f"{kind} D {d} x {s_max}, {hq}/{hkv} heads, B {b}"
                 + (f", gamma {gamma}" if gamma else ""))
        if (b, hq, hkv) == (4, 4, 2):       # the CLI's own heads: the CLI
            argv = (["--head-dim", str(d), "--seq-len", str(s_max),
                     "--iters", str(TILE_ITERS)]
                    + (["--gamma", str(gamma)] if gamma else []))
            print(f"[autotune] {label}: python -m "
                  f"repro_torch.kernels.autotune {' '.join(argv)}")
            timings, winner = autotune.main(argv)
        elif kind == "decode":
            print(f"[autotune] sweep {label}:")
            timings = autotune.sweep_decode_tiles(d, s_max, b=b, hq=hq,
                                                  hkv=hkv, iters=TILE_ITERS,
                                                  verbose=True)
            winner = autotune.decode_tile(d, s_max)
        else:
            print(f"[autotune] sweep {label}:")
            timings = autotune.sweep_verify_tiles(d, s_max, gamma, b=b,
                                                  hq=hq, hkv=hkv,
                                                  iters=TILE_ITERS,
                                                  verbose=True)
            winner = autotune.verify_tile(d, s_max, gamma)
        looked = (autotune.verify_tile(d, s_max, gamma) if gamma
                  else autotune.decode_tile(d, s_max))
        check(looked == winner == min(timings, key=timings.get),
              f"autotune {label}: the lookup gives {looked}, the winner is "
              f"{winner}")
        tables[label] = dict(kind=kind, d=d, s_max=s_max, gamma=gamma, b=b,
                             hq=hq, hkv=hkv, winner=list(winner),
                             us={f"{bk}/{gp}": (t * 1e6 if math.isfinite(t)
                                                else None)
                                 for (bk, gp), t in timings.items()})
    sweep_launches = {"decode": K.dense_launches,
                      "verify": K.dense_verify_launches,
                      "tiles": {f"{k[0]} stage {k[1]} rows {k[2]}": n
                                for k, n in sorted(K.tile_launches.items())}}
    check(sweep_launches["decode"] > 0 and sweep_launches["verify"] > 0,
          f"the sweeps launched no dense decode or verify: {sweep_launches}")
    print(f"[autotune] the sweeps' launches: fused dense decode "
          f"{sweep_launches['decode']}, dense verify "
          f"{sweep_launches['verify']}, by tile instance "
          f"{sweep_launches['tiles']}")

    # every instance against its exact plain version, on each sweep's inputs
    n_checked = 0
    for label, tab in tables.items():
        cfg, args = autotune._inputs(tab["d"], tab["s_max"], tab["gamma"],
                                     tab["b"], tab["hq"], tab["hkv"], 0,
                                     "cuda")
        if tab["kind"] == "decode":
            q_q = qlib.quantize(args[0], args[4][:, None, None])
            want = K.splitmax_decode_fused_plain(*args, cfg=cfg, exact=True)
        else:
            want = K.splitmax_decode_fused_verify_plain(*args, cfg=cfg,
                                                        exact=True)
        for key, us in tab["us"].items():
            if us is None:
                continue
            bk, gp = map(int, key.split("/"))
            kw = dict(cfg=cfg, block_k=bk, g_pad_min=gp)
            if tab["kind"] == "decode":
                got = [K.splitmax_decode_fused_cuda(*args, **kw),
                       K.splitmax_decode_cuda(q_q, *args[1:4], *args[5:],
                                              **kw)]
            else:
                got = [K.splitmax_decode_fused_verify_cuda(*args, **kw)]
            torch.cuda.synchronize()
            check(all(torch.equal(g, want) for g in got),
                  f"autotune {label}, tile {key}: the instance differs from "
                  f"its exact plain version")
            n_checked += len(got)
    print(f"[autotune] {n_checked} instance runs over the sweeps' inputs: "
          f"each == its exact=True plain version, bit for bit")

    # kernel 3's row paddings at the verify sweeps' shapes, from a pool
    paged = {}
    for label, tab in tables.items():
        if tab["kind"] != "verify":
            continue
        cfg, args = autotune._inputs(tab["d"], tab["s_max"], tab["gamma"],
                                     tab["b"], tab["hq"], tab["hkv"], 0,
                                     "cuda")
        q, k, v = args[:3]
        kp, vp, table = dense_to_pool(torch, torch.Generator(device="cuda"),
                                      k, v, K.DENSE_BLOCK_K)
        pargs = (q, kp, vp, table, *args[3:])
        want = K.splitmax_decode_fused_verify_paged_plain(*pargs, cfg=cfg,
                                                          exact=True)
        times = {}
        for gp in autotune.CANDIDATE_G_PAD:
            got = K.splitmax_decode_fused_verify_paged_cuda(
                *pargs, cfg=cfg, g_pad_min=gp)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"kernel 3 g_pad_min {gp} at "
                  f"{label}: differs from its exact plain version")
            times[gp] = autotune._time_call(
                lambda *a, _gp=gp: K.splitmax_decode_fused_verify_paged_cuda(
                    *a, cfg=cfg, g_pad_min=_gp), *pargs,
                iters=TILE_ITERS) * 1e6
        paged[label] = times
        print(f"[autotune] kernel 3 at {label} (pool block_k "
              f"{K.DENSE_BLOCK_K}): g_pad_min 8 {times[8]:.2f} us, 16 "
              f"{times[16]:.2f} us, each == its exact plain version")

    # the dense churn with its cache at 2048: unswept, then the winner
    cfg = get_arch("tinyllama_1p1b").config
    params = T.init_params(cfg, seed=SERVE["seed"], device=dev)
    prompts, gens = churn(cfg)
    runs = {}
    swept = autotune.decode_tile(cfg.hd, TILE_CHURN_MAX_LEN)
    for what in ("unswept", "swept", "unswept again"):
        autotune.clear_sweep_cache()
        if what == "swept":
            autotune._SWEEP_CACHE[("decode", cfg.hd, TILE_CHURN_MAX_LEN,
                                   autotune.kernels_supported())] = swept
        tile = autotune.decode_tile(cfg.hd, TILE_CHURN_MAX_LEN)
        # the heuristic's answer launches the default instance (stage 0)
        stage = (K.tile_instance(tile[0], tile[1], TILE_CHURN_MAX_LEN)[0]
                 if autotune.swept("decode", cfg.hd, TILE_CHURN_MAX_LEN)
                 else 0)
        K.dense_launches = 0
        K.tile_launches.clear()
        stats = srv.serve_dense(params, cfg, prompts, slots=SERVE["slots"],
                                gen=SERVE["gen"], gens=gens,
                                max_len=TILE_CHURN_MAX_LEN)
        torch.cuda.synchronize()
        check_served(stats, gens, cfg.vocab_size, f"dense churn {what}",
                     overshoot=1)
        n_tile = (K.tile_launches.get(("decode", stage, 16), 0) if stage
                  else K.dense_launches - sum(K.tile_launches.values()))
        check(n_tile == K.dense_launches
              == stats["decode_steps"] * cfg.n_layers > 0,
              f"dense churn {what}: tile {tile} (stage {stage}) launched "
              f"{n_tile} of {K.dense_launches} dense decodes")
        runs[what] = dict(tile=list(tile), stage=stage,
                          launches=K.dense_launches,
                          p50_step_ms=stats["p50_step_ms"],
                          tok_s=stats["tok_s"], finished=stats["finished"])
        print(f"[autotune] dense churn at max_len {TILE_CHURN_MAX_LEN}, "
              f"{what}: tile {tile} -> "
              f"{f'stage {stage}' if stage else 'the default'} instance, "
              f"{K.dense_launches} launches, {stats['tok_s']:.1f} tok/s, "
              f"p50 step {stats['p50_step_ms']:.2f} ms")
    check(runs["swept"]["finished"] == runs["unswept"]["finished"]
          == runs["unswept again"]["finished"],
          "dense churn: the swept winner's tokens differ from the unswept "
          "run's")
    print(f"[autotune] dense churn tokens with the swept winner {swept} == "
          f"unswept (heuristic {runs['unswept']['tile']}), bit for bit")
    autotune.clear_sweep_cache()
    del params
    torch.cuda.empty_cache()
    for r in runs.values():
        del r["finished"]
    print(f"[autotune] phase 16 wall time {time.perf_counter() - t_phase:.1f} s")
    return dict(tables=tables, sweep_launches=sweep_launches,
                paged_g_pad_us=paged, churn=runs)


def main() -> int:
    t_script = time.perf_counter()
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
    from repro_torch import trace

    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    dev = resolve_device("cuda")

    t0 = time.perf_counter()
    trace.enable()
    logs = cuda_build.build()
    built = {s["attrs"]["source"]: (s["t1"] - s["t0"]) * 1e-9
             for s in trace.drain()["spans"]}
    trace.disable()
    print(f"[build] {sorted(cuda_build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s, in parallel; each source's nvcc "
          + ", ".join(f"{n} {t:.1f} s" for n, t in sorted(built.items())))
    for name, log in logs.items():
        entry, spills = "?", ""
        for line in log.splitlines():        # ptxas -v, one block per kernel
            if "Function properties for" in line:
                entry = line.split("for", 1)[1].strip()
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                print(f"[build] {name} {entry}: {line.split(':', 1)[1].strip()}; "
                      f"{spills}")

    dryruns = start_dryruns(src)
    example_dryruns = start_example_dryruns(src.parent)
    decode, decode_args = decode_phase(torch, F, dev)
    kernels = [prefill_phase(torch, F, dev), decode,
               verify_phase(torch, F, dev),
               composed_phase(torch, dev, decode_args),
               *dense_decode_phase(torch, F, dev),
               dense_verify_phase(torch, F, dev), int8_gemm_phase(torch, dev),
               w8_linear_phase(torch, dev)]
    options_phase(torch, dev, kernels)
    graph_phase(torch, dev, kernels)
    smoke_reference_phase(torch, dev)

    from repro_torch.configs import get_arch
    from repro_torch.kernels import int8_matmul, splitmax_decode
    from repro_torch.models import transformer as T
    cfg = get_arch("tinyllama_1p1b").config
    params = T.init_params(cfg, seed=SERVE["seed"], device=dev)
    print(f"[serve] {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype} compute), seeded random weights")
    # kernels 7 and 8 have no caller in any model: their counts stay 0 over
    # every model's main path below (kernel 7's one caller is the tile
    # sweep of phase 16)
    splitmax_decode.dense_verify_launches = int8_matmul.launches = 0
    int8_matmul.pack_launches = 0
    plain, launches = serve_phase(torch, dev, params, cfg)
    launches["splitmax_decode_fused_verify_paged"] = spec_serve_phase(
        torch, dev, params, cfg, plain)
    launches["splitmax_decode_paged"] = composed_serve_phase(torch, dev,
                                                             params, cfg)
    dense = dense_serve_phase(torch, dev, params, cfg)
    n_pressure = pressure_phase(torch, dev, params, cfg, plain)
    chaos_phase(torch, dev, params, cfg, plain)
    sampled_phase(torch, dev, params, cfg, plain)
    serve_p50_ms = plain["p50_step_ms"]
    del params, plain
    torch.cuda.empty_cache()
    n_fq_smoke = train_smoke_phase(torch, dev)
    n_fq_full = train_full_phase(torch, dev)
    t_phase = time.perf_counter()
    mesh_roofline_phase(torch, dev, dryruns, serve_p50_ms)
    print(f"[mesh] phase 13 wall time {time.perf_counter() - t_phase:.1f} s")
    moe_smoke_phase(torch, dev)
    moe = moe_phase(torch, dev)
    dense_smoke_phase(torch, dev)
    nemo = dense_full_phase(torch, dev, NEMO_ARCH, speculative=True)
    olmo = dense_full_phase(torch, dev, OLMO_ARCH, speculative=False)
    encdec_smoke_check(torch, dev)
    seamless, seamless_subs, seamless_errs = encdec_full_phase(torch, F, dev)
    ssm_smoke_check(torch, dev)
    falcon_full_phase(torch, dev)
    hybrid, hybrid_subs, hybrid_errs = hybrid_full_phase(torch, F, dev)
    # no model calls kernels 7 and 8: their counts are still 0 here
    check(splitmax_decode.dense_verify_launches == int8_matmul.launches
          == int8_matmul.pack_launches == 0, "the dense verify or the int8 "
          "GEMM launched on a model's path")
    t_phase = time.perf_counter()
    int8_smoke_check(torch, dev)
    decode_baselines_check(torch, dev)
    ds67b = dense_full_phase(torch, dev, DS_ARCH, speculative=True, int8=True,
                             tag="ds67b", **DS_CHURN)
    ds_subs, ds_errs = deepseek_kernel_shapes(torch, F, dev)
    tinyllama_int8_vs_bf16(torch, dev)
    cim = cim_phase(torch, dev)
    print(f"[ds67b] phase 12 wall time {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    n_fq_families = sum(family_smoke_train(torch, dev, arch)
                        for arch in FAMILY_SMOKE_ARCHS)
    families_full_phase(torch, dev)
    print(f"[train-families] phase 14 wall time "
          f"{time.perf_counter() - t_phase:.1f} s")
    examples = examples_phase(torch, dev, example_dryruns)
    tiles = autotune_phase(torch, dev)
    by_path = {"paged churn": launches["splitmax_attention"],
               "dense churn": dense.pop("splitmax_attention"),
               "pressure churn": n_pressure,
               "fakequant->int8 check, smoke": n_fq_smoke,
               "fakequant->int8 check, full width": n_fq_full,
               "fakequant->int8 checks, other families": n_fq_families,
               "moe churn": moe["splitmax_attention"],
               "mistral-nemo churn": nemo["splitmax_attention"],
               "olmo churn": olmo["splitmax_attention"],
               "seamless churn": seamless["splitmax_attention"],
               "zamba2 dense churn": hybrid["splitmax_attention"],
               "deepseek-67b int8 churn": ds67b["splitmax_attention"],
               "examples (quickstart, serve_batched, accuracy_study)":
                   examples["splitmax_attention"]}
    decode_by_path = {
        "paged churn": launches["splitmax_decode_fused_paged"],
        "moe churn": moe["splitmax_decode_fused_paged"],
        "mistral-nemo churn": nemo["splitmax_decode_fused_paged"],
        "olmo churn": olmo["splitmax_decode_fused_paged"],
        "seamless churn": seamless["splitmax_decode_fused_paged"],
        "deepseek-67b int8 churn": ds67b["splitmax_decode_fused_paged"],
        "examples (serve_batched)": examples["splitmax_decode_fused_paged"]}
    verify_by_path = {
        "speculative churn (self, self:4)":
            launches["splitmax_decode_fused_verify_paged"],
        "moe speculative churn": moe["splitmax_decode_fused_verify_paged"],
        "mistral-nemo speculative churn":
            nemo["splitmax_decode_fused_verify_paged"],
        "deepseek-67b int8 speculative churn":
            ds67b["splitmax_decode_fused_verify_paged"]}
    for paths in (by_path, decode_by_path, verify_by_path):
        for path, n in paths.items():
            check(n > 0, f"no split-softmax launch on the {path} path")
    launches["splitmax_decode_fused_paged"] = sum(decode_by_path.values())
    launches["splitmax_decode_fused_verify_paged"] = sum(
        verify_by_path.values())
    launches["splitmax_attention"] = sum(by_path.values())
    check(seamless["splitmax_decode_paged"] > 0, "no composed decode launch "
          "on the seamless composed churn")
    check(ds67b["splitmax_decode_paged"] > 0, "no composed decode launch "
          "on the deepseek-67b int8 composed churn")
    launches["splitmax_decode_paged"] += (seamless["splitmax_decode_paged"]
                                          + ds67b["splitmax_decode_paged"])
    launches.update(dense)
    for name, what in (("splitmax_decode_fused", "zamba2 dense churn"),
                       ("splitmax_decode", "zamba2 composed dense churn")):
        check(hybrid[name] > 0, f"no {name} launch on the {what}")
        launches[name] += hybrid[name]
    check(examples["splitmax_decode_fused"] > 0,
          "no splitmax_decode_fused launch on the quickstart example")
    launches["splitmax_decode_fused"] += examples["splitmax_decode_fused"]
    # kernel 7's one caller is the tile sweep (phase 16), as in the
    # reference's tree
    launches["splitmax_decode_fused_verify"] = (
        tiles["sweep_launches"]["verify"])
    # kernel 8's body and its K-major pre-pass, each counted at its launch
    # on its one path, the CIM datapath model
    launches["int8_matmul"] = sum(cim["launches_by_path"].values())
    launches["int8_matmul pre-pass"] = sum(
        cim["pre_pass_launches_by_path"].values())
    # kernel 9 on DeepSeek-67B's int8 churn: its decode steps' linears
    launches["w8_linear"] = ds67b["w8_linear"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] in examples:
            k["examples_launches"] = examples[k["name"]]
    k8 = next(k for k in kernels if k["name"] == "int8_matmul")
    k8.update(pre_pass_launches=launches["int8_matmul pre-pass"],
              path="core/cim.py: nibble_split_matmul, serial_bit_matmul",
              launches_by_path=cim.pop("launches_by_path"), cim=cim)
    for k, paths in zip(kernels, (by_path, decode_by_path, verify_by_path)):
        k["launches_by_path"] = paths
    for k in kernels:
        if k["name"] in seamless_subs:
            k["seamless"] = seamless_subs[k["name"]]
        if k["name"] in hybrid_subs:
            k["zamba2"] = hybrid_subs[k["name"]]
        if k["name"] in ds_subs:
            k["deepseek67b"] = ds_subs[k["name"]]
    err_of = {"splitmax_attention": seamless_errs["splitmax_attention"],
              "splitmax_decode_fused_paged": seamless_errs["decode"],
              "splitmax_decode_paged": seamless_errs["composed"]}
    for k in kernels:
        for errs in (err_of, hybrid_errs, ds_errs):
            if k["name"] in errs:
                k["max_abs_err"] = max(k["max_abs_err"], errs[k["name"]])
    for name in ("splitmax_attention", "splitmax_decode_fused_paged",
                 "splitmax_decode_fused_verify_paged", "splitmax_decode_paged",
                 "splitmax_decode_fused", "splitmax_decode", "int8_matmul",
                 "int8_matmul pre-pass", "w8_linear"):
        check(launches[name] > 0, f"{name} never launched on the main path")
    check(launches["splitmax_decode_fused_verify"] > 0,
          "the tile sweep never launched the dense verify")
    # the swept tiles of kernels 3, 4, 6 and 7 (phase 16)
    by_kind = {"splitmax_decode_fused": "decode", "splitmax_decode": "decode",
               "splitmax_decode_fused_verify": "verify"}
    for k in kernels:
        kind = by_kind.get(k["name"])
        if kind is not None:
            k["tiles"] = {label: {"winner": t["winner"], "us": t["us"]}
                          for label, t in tiles["tables"].items()
                          if t["kind"] == kind}
        if k["name"] == "splitmax_decode_fused_verify":
            k["launches_by_path"] = {"tile sweep (phase 16)":
                                     k["launches"]}
        if k["name"] == "splitmax_decode_fused":
            k["tile_sweep_launches"] = tiles["sweep_launches"]["decode"]
            k["tile_churn"] = tiles["churn"]
        if k["name"] == "splitmax_decode_fused_verify_paged":
            k["g_pad_min_us"] = tiles["paged_g_pad_us"]

    print(f"[wall] chip_smoke.py {time.perf_counter() - t_script:.1f} s, "
          f"the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
