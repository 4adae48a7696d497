"""Split-softmax decode and speculative verify over the paged pool and the
dense cache: the CUDA kernels' wrappers and their plain PyTorch versions
(port of ``repro/kernels/splitmax_decode.py``).

Three paged entries, each a hand-written kernel with its plain version:

  * fused decode (``csrc/splitmax_decode.cu``): one new token per slot, the
    f32 query ``(B, Hq, D)`` is quantized in-kernel with the slot's own
    ``s_q`` and streams against the int8 pool ``(num_blocks, Hkv, block_k,
    D)`` through the slot's block-table row, masked at ``cache_len`` (and
    the window), giving ``(B, Hq, D)`` f32;
  * composed decode (the same source, a compile-time variant): the query
    arrives already int8 (``--fused off``);
  * fused verify (``csrc/splitmax_verify.cu``): the T draft queries
    ``(B, Hq, T, D)`` of every slot in one launch; token t is quantized with
    ``s_q[b, t]`` and sees ``cache_len[b] - (T-1-t)`` positions, so each row
    is the fused decode at that length.

The same three functions run over a dense ``(B, Hkv, S_max, D)`` int8 cache
(``kDense`` variants of the same kernels): slot b reads its own rows,
masked at ``cache_len[b]`` (and the window), in tiles of ``DENSE_BLOCK_K``
positions; ``S_max`` need not be a multiple of the tile.  Dense and paged
give equal bits on the same logical K/V when the dense tile equals the
pool's ``block_k``.

The CUDA kernels sum ``e * v`` and ``e`` exactly in integers and convert
each to f32 once (``csrc/splitmax_common.cuh``), so their bits do not depend
on how the keys are split; every plain version takes ``exact=True`` for the
same function (f64 sums of integers, rounded once), and by default the f32
matmul of the reference.  Every entry takes ``exact_recip`` (a division in
place of the reciprocal LUT; a compile-time variant of each kernel).

The dense decode and the dense verify also launch tile instances, picked by
the reference's ``(block_k, g_pad_min)`` (:func:`tile_instance`; the
mapping is set out in ``kernels/autotune.py``), and the paged verify a
row-padding instance for ``g_pad_min`` 16 (``csrc/splitmax_verify_tiles.cuh``).
``block_k=None`` launches the default instance, the kernel as it was before
tiles were parameters.  A tile with no compiled instance raises.  The plain
dense versions take ``block_k`` too: with ``exact=True`` it cuts their
exact sums into chunks of that many keys (the same bits at every
``block_k``); the f32 default ignores it, as the reference's ref path does.

Tiles whose table entry is the trash block (id 0) are dead.  A live slot
never has one inside its length (the allocator never hands out block 0), so
this changes nothing for live slots; an idle slot (length 0, row all trash)
gets an all-zero row, where the reference reads block 0 and returns
whatever it holds.  Idle rows are discarded by the scheduler either way.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core import paged_kv
from repro_torch.core import quantization as qlib
from repro_torch.core.lut import LUTConfig
from repro_torch.kernels import cuda_build

# Launches of each CUDA kernel since the last reset (plain versions and CPU
# calls never count): fused, composed and verify over the paged pool, then
# over the dense cache.
launches = 0
composed_launches = 0
verify_launches = 0
dense_launches = 0
dense_composed_launches = 0
dense_verify_launches = 0
# launches of each tile instance, keyed (kind, stage, row_pad), kind
# "decode", "decode_composed", "verify" or "verify_paged"; the default
# instances are not counted here
tile_launches: Dict[Tuple[str, int, int], int] = {}

DENSE_BLOCK_K = 32            # dense k-tile: the serving pool's block_k;
                              # also the verify's kTileK
TILE_STAGES = (1, 2, 4, 8, 16)  # tiles a rank holds in flight: block_k / 32
TILE_BLOCK_KS = tuple(DENSE_BLOCK_K * s for s in TILE_STAGES)
G_PADS = (8, 16)              # the reference's g_pad_min: rows padded to 2x
SMEM_MAX = 227 * 1024         # an H100 block's dynamic shared memory
# the verify's tile instances by row padding (csrc/splitmax_verify_tiles*.cu)
TILE_LIBS = {16: "splitmax_verify_tiles", 32: "splitmax_verify_tiles_pad"}

THREADS = 128                 # kThreads in csrc/splitmax_common.cuh
MAX_OUT_PER_THREAD = 16       # kMaxOut in csrc/splitmax_common.cuh
VERIFY_MAX_ROWS_D = 16384     # kMaxRowsD in csrc/splitmax_verify.cu
MAX_HEAD_DIM = 256            # kMaxD in csrc/splitmax_verify.cu
MAX_EXP_FRAC_BITS = 15        # e <= 2^15 keeps the kernels' int32 chunks exact
_LIBS = {}


def _lib(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library with its launchers' signatures set."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = cuda_build.load(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "splitmax_decode":
            sigs = {"splitmax_decode_fused_paged_launch": [p] * 11 + [i] * 10,
                    "splitmax_decode_paged_launch": [p] * 10 + [i] * 10,
                    "splitmax_decode_fused_dense_launch": [p] * 10 + [i] * 11,
                    "splitmax_decode_dense_launch": [p] * 9 + [i] * 11}
        elif name == "splitmax_verify":
            sigs = {"splitmax_verify_paged_launch": [p] * 11 + [i] * 11,
                    "splitmax_verify_dense_launch": [p] * 10 + [i] * 11}
        else:          # the verify's tile instances, rows padded to 16 or 32
            sigs = {"splitmax_verify_tile_dense_launch": [p] * 10 + [i] * 12}
            if name.endswith("_pad"):
                sigs["splitmax_verify_tile_paged_launch"] = [p] * 11 + [i] * 11
        for fn_name, args in sigs.items():
            getattr(lib, fn_name).argtypes = args + [p]
            getattr(lib, fn_name).restype = i
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [i]
        err_fn.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def dense_live_positions(cache_len, s_max: int,
                         window: Optional[int]) -> torch.Tensor:
    """(B, s_max) bool: the cache positions a slot attends."""
    pos = torch.arange(s_max, device=cache_len.device)[None, :]
    lens = cache_len.to(torch.int64)[:, None]
    live = pos < lens
    if window is not None:
        live = live & (pos > lens - 1 - window)
    return live


def live_positions(block_table, cache_len, block_k: int,
                   window: Optional[int]) -> torch.Tensor:
    """(B, max_blocks * block_k) bool: the pool positions a slot attends."""
    live = dense_live_positions(cache_len, block_table.shape[1] * block_k,
                                window)
    return live & (block_table.repeat_interleave(block_k, dim=1)
                   != paged_kv.TRASH_BLOCK)


# ------------------------------------------------------------ tile instances --

def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def tile_instance(block_k: Optional[int], g_pad_min: int, s_max: int
                  ) -> Tuple[int, int]:
    """``(stage, row_pad)`` of the instance for the reference's tile
    ``(block_k, g_pad_min)`` over ``s_max`` cached positions: ``stage =
    block_k / 32`` tiles of 32 keys a rank holds in flight, 0 for the
    default instance (``block_k`` None, or ``s_max`` itself: the
    reference's one tile over a cache that no candidate divides, which the
    ragged tiles here need no instance for); ``row_pad = 2 * g_pad_min``
    query rows (16: one m16 tile).  Raises for any other tile."""
    if g_pad_min not in G_PADS:
        raise ValueError(f"g_pad_min {g_pad_min}: no compiled instance "
                         f"(candidates {G_PADS})")
    if block_k is None or (block_k == s_max
                           and block_k not in TILE_BLOCK_KS):
        return 0, 2 * g_pad_min
    if block_k not in TILE_BLOCK_KS:
        raise ValueError(f"block_k {block_k}: no compiled instance "
                         f"(candidates {TILE_BLOCK_KS} or s_max {s_max})")
    return block_k // DENSE_BLOCK_K, 2 * g_pad_min


def decode_smem_bytes(group: int, d: int, stage: int,
                      cfg: LUTConfig) -> int:
    """Dynamic shared memory of a dense decode instance with ``stage``
    tiles of 32 keys (``smem_layout`` of ``csrc/splitmax_decode.cu``)."""
    e_tile = group * (DENSE_BLOCK_K + 1) * 4
    k_tile = DENSE_BLOCK_K * (d // 4 + 1) * 4
    v_tile = DENSE_BLOCK_K * d
    fixed = (_align16(256 * 4) + _align16((1 << cfg.recip_index_bits) * 4)
             + _align16(group * d) + _align16(group * d * 8)
             + _align16(group * 8) + _align16(max(stage, 4) * 8)
             + _align16(max(stage, 4) * 4))
    return (fixed + _align16(stage * e_tile) + _align16(stage * k_tile)
            + stage * _align16(v_tile))


def verify_smem_bytes(rows: int, d: int, stage: int, row_pad: int,
                      cfg: LUTConfig) -> int:
    """Dynamic shared memory of a verify instance with ``rows`` query rows
    (group x T) padded to ``row_pad`` and ``stage`` tiles of 32 keys
    (``smem_layout`` of ``csrc/splitmax_verify.cuh``)."""
    dp = (d + 31) // 32 * 32
    pitch = dp + 16
    rows_pad = (rows + row_pad - 1) // row_pad * row_pad
    return (_align16(256 * 4) + _align16((1 << cfg.recip_index_bits) * 4)
            + _align16(rows_pad * pitch) + _align16(rows * d * 8)
            + _align16(rows * 8) + _align16((rows + 7) // 8 * 8)
            + _align16(stage * DENSE_BLOCK_K * 8)
            + _align16(stage * DENSE_BLOCK_K * pitch)
            + _align16(stage * DENSE_BLOCK_K * d)
            + _align16(stage * d * (DENSE_BLOCK_K + 16)))


def tile_refusal(kind: str, block_k: int, g_pad_min: int, *, group: int,
                 d: int, s_max: int, cfg: LUTConfig, tokens: int = 1
                 ) -> Optional[str]:
    """Why the card cannot run the tile instance of ``kind`` ("decode" or
    "verify") for ``(block_k, g_pad_min)``, or None: a tile with no
    instance, or a layout past the 227 KB of shared memory a block may
    hold.  The default instance (stage 0) sizes itself and is never
    refused here."""
    try:
        stage, row_pad = tile_instance(block_k, g_pad_min, s_max)
    except ValueError as err:
        return str(err)
    if stage == 0:
        if kind == "verify" and row_pad != 16:
            return (f"block_k {block_k} = s_max with g_pad_min {g_pad_min}: "
                    f"no compiled dense verify instance")
        return None
    smem = (decode_smem_bytes(group, d, stage, cfg) if kind == "decode"
            else verify_smem_bytes(group * tokens, d, stage, row_pad, cfg))
    if smem > SMEM_MAX:
        return (f"{smem / 1024:.1f} KB of shared memory at D {d}, group "
                f"{group}" + (f", T {tokens}" if kind == "verify" else "")
                + f" > {SMEM_MAX // 1024} KB")
    return None


# ------------------------------------------------------------ plain versions --

def _grouped_decode(q_q, k_c, v_c, live, m_z, s_v, exp_lut, recip_lut,
                    cfg: LUTConfig, exact_recip: bool = False,
                    exact: bool = False,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """The grouped int8 split-softmax decode of ``q_q (B, Hq, D)`` over a
    contiguous int8 cache ``(B, Hkv, S, D)`` at the ``live (B, S)``
    positions; ``m_z`` is per-slot ``(B,)``.  ``exact`` takes ``e @ v`` and
    ``e.sum`` in f64 (every partial sum is an integer below 2^53) and rounds
    each to f32 once: the CUDA kernels' contract, bit for bit; with
    ``block_k`` it sums them over chunks of that many keys, one after the
    other (the same integers).  ``exact_recip`` divides in place of the
    reciprocal LUT."""
    b, hq, d = q_q.shape
    hkv = k_c.shape[1]
    g = hq // hkv
    # exact f32 integer dot products (|z32| <= D * 2^14 < 2^24)
    z32 = (q_q.reshape(b, hkv, g, d).to(torch.float32)
           @ k_c.to(torch.float32).transpose(-1, -2))
    z_q = qlib.requantize_int32(z32, m_z[:, None, None, None])
    e = lut_lib.exp_lookup(z_q, exp_lut).to(torch.float32)   # (B,Hkv,G,S)
    dt = torch.float64 if exact else torch.float32
    e = torch.where(live[:, None, None, :], e, 0.0).to(dt)
    v_c = v_c.to(dt)
    if exact and block_k is not None:
        acc = torch.zeros(e.shape[:3] + (d,), dtype=dt, device=e.device)
        s = torch.zeros(e.shape[:3] + (1,), dtype=dt, device=e.device)
        for k0 in range(0, e.shape[-1], block_k):
            ec = e[..., k0:k0 + block_k]
            acc = acc + ec @ v_c[:, :, k0:k0 + block_k]
            s = s + ec.sum(-1, keepdim=True)
        acc = acc.to(torch.float32)
    else:
        acc = (e @ v_c).to(torch.float32)                    # (B,Hkv,G,D)
        s = e.sum(-1, keepdim=True)
    r = lut_lib.recip_factor(s, recip_lut, cfg, exact_recip)
    out = acc * r * s_v
    return out.reshape(b, hq, d)


def splitmax_decode_paged_plain(q_q, k_pages, v_pages, block_table, m_z, s_v,
                                cache_len, exp_lut, recip_lut, *,
                                cfg: LUTConfig, window: Optional[int] = None,
                                exact_recip: bool = False,
                                exact: bool = False) -> torch.Tensor:
    """The composed kernel's function in plain PyTorch: gather the cache
    through the table, then the grouped int8 split-softmax decode of the
    int8 query ``q_q (B, Hq, D)``.  ``m_z`` is per-slot ``(B,)``."""
    live = live_positions(block_table, cache_len, k_pages.shape[2], window)
    return _grouped_decode(q_q, paged_kv.gather_kv(k_pages, block_table),
                           paged_kv.gather_kv(v_pages, block_table), live,
                           m_z, s_v, exp_lut, recip_lut, cfg, exact_recip,
                           exact)


def splitmax_decode_fused_paged_plain(q, k_pages, v_pages, block_table, m_z,
                                      s_q, s_v, cache_len, exp_lut, recip_lut,
                                      *, cfg: LUTConfig,
                                      window: Optional[int] = None,
                                      exact_recip: bool = False,
                                      exact: bool = False) -> torch.Tensor:
    """The fused kernel's function in plain PyTorch: quantize each slot's
    query with its own ``s_q (B,)``, then the composed decode."""
    return splitmax_decode_paged_plain(
        qlib.quantize(q, s_q[:, None, None]), k_pages, v_pages, block_table,
        m_z, s_v, cache_len, exp_lut, recip_lut, cfg=cfg, window=window,
        exact_recip=exact_recip, exact=exact)


def splitmax_decode_fused_verify_paged_plain(q, k_pages, v_pages, block_table,
                                             m_z, s_q, s_v, cache_len,
                                             exp_lut, recip_lut, *,
                                             cfg: LUTConfig,
                                             window: Optional[int] = None,
                                             exact_recip: bool = False,
                                             exact: bool = False,
                                             g_pad_min: int = 8
                                             ) -> torch.Tensor:
    """The verify kernel's function in plain PyTorch, the reference's
    ``_verify_fallback``: token t is the fused decode at ``cache_len -
    (T-1-t)`` with ``s_q[:, t]`` and ``m_z[:, t]``, stacked on axis 2
    (``g_pad_min``, the kernel's row padding, changes nothing here)."""
    t = q.shape[2]
    outs = [splitmax_decode_fused_paged_plain(
        q[:, :, i].contiguous(), k_pages, v_pages, block_table,
        m_z[:, i].contiguous(), s_q[:, i].contiguous(), s_v,
        cache_len - (t - 1 - i), exp_lut, recip_lut, cfg=cfg, window=window,
        exact_recip=exact_recip, exact=exact) for i in range(t)]
    return torch.stack(outs, dim=2)


def splitmax_decode_plain(q_q, k_cache, v_cache, m_z, s_v, cache_len,
                          exp_lut, recip_lut, *, cfg: LUTConfig,
                          window: Optional[int] = None,
                          exact_recip: bool = False,
                          exact: bool = False,
                          block_k: Optional[int] = None,
                          g_pad_min: int = 8) -> torch.Tensor:
    """The composed dense kernel's function in plain PyTorch: int8 ``q_q
    (B, Hq, D)`` against the dense cache ``(B, Hkv, S_max, D)``.  A plain
    version pads no rows: ``g_pad_min`` is taken for the kernel's
    signature only."""
    live = dense_live_positions(cache_len, k_cache.shape[2], window)
    return _grouped_decode(q_q, k_cache, v_cache, live, m_z, s_v, exp_lut,
                           recip_lut, cfg, exact_recip, exact, block_k)


def splitmax_decode_fused_plain(q, k_cache, v_cache, m_z, s_q, s_v,
                                cache_len, exp_lut, recip_lut, *,
                                cfg: LUTConfig, window: Optional[int] = None,
                                exact_recip: bool = False,
                                exact: bool = False,
                                block_k: Optional[int] = None,
                                g_pad_min: int = 8) -> torch.Tensor:
    """The fused dense kernel's function in plain PyTorch: quantize each
    slot's query with its own ``s_q (B,)``, then the composed decode."""
    return splitmax_decode_plain(
        qlib.quantize(q, s_q[:, None, None]), k_cache, v_cache, m_z, s_v,
        cache_len, exp_lut, recip_lut, cfg=cfg, window=window,
        exact_recip=exact_recip, exact=exact, block_k=block_k)


def splitmax_decode_fused_verify_plain(q, k_cache, v_cache, m_z, s_q, s_v,
                                       cache_len, exp_lut, recip_lut, *,
                                       cfg: LUTConfig,
                                       window: Optional[int] = None,
                                       exact_recip: bool = False,
                                       exact: bool = False,
                                       block_k: Optional[int] = None,
                                       g_pad_min: int = 8) -> torch.Tensor:
    """The dense verify kernel's function in plain PyTorch, the reference's
    ``_verify_fallback``: token t is the fused dense decode at ``cache_len
    - (T-1-t)``, stacked on axis 2."""
    t = q.shape[2]
    outs = [splitmax_decode_fused_plain(
        q[:, :, i].contiguous(), k_cache, v_cache, m_z[:, i].contiguous(),
        s_q[:, i].contiguous(), s_v, cache_len - (t - 1 - i), exp_lut,
        recip_lut, cfg=cfg, window=window, exact_recip=exact_recip,
        exact=exact, block_k=block_k) for i in range(t)]
    return torch.stack(outs, dim=2)


# ---------------------------------------------------------- kernel wrappers --

def _check(q, q_dtype, per_slot, k_pages, v_pages, block_table, s_v,
           cache_len, exp_lut, recip_lut, cfg, window, *, tokens: int,
           threads: Optional[int]):
    """Raise ValueError unless the inputs are what the kernels take.
    ``per_slot`` names the per-slot scale tensors, each ``(B,)`` or, for a
    verify's ``q (B, Hq, T, D)``, ``(B, T)``.  ``block_table`` None means a
    dense cache ``(B, Hkv, S_max, D)`` in ``k_pages``/``v_pages``.
    ``threads`` is the decode kernel's block, whose registers hold group x D
    outputs; None for the verify kernels, whose shared memory holds the
    int64 partials of group x T x D outputs (``VERIFY_MAX_ROWS_D``)."""
    dev = q.device
    named = [("q", q, q_dtype), ("k_cache", k_pages, torch.int8),
             ("v_cache", v_pages, torch.int8),
             ("s_v", s_v, torch.float32), ("cache_len", cache_len, torch.int32),
             ("exp_lut", exp_lut, torch.int32),
             ("recip_lut", recip_lut, torch.int32)]
    if block_table is not None:
        named.append(("block_table", block_table, torch.int32))
    named += [(name, t, torch.float32) for name, t in per_slot.items()]
    for name, t, dt in named:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"cache {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    b, hq, d = q.shape[0], q.shape[1], q.shape[-1]
    _, hkv, _, dk = k_pages.shape
    if dk != d or hq % hkv or (block_table is None and k_pages.shape[0] != b):
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_pages.shape)}")
    rows = (hq // hkv) * tokens
    if threads is not None:
        if d % 16 or rows * d > threads * MAX_OUT_PER_THREAD:
            raise ValueError(f"head_dim {d} x group {hq // hkv} x {tokens} "
                             f"tokens: the kernel takes D a multiple of 16 "
                             f"with rows * D <= {threads * MAX_OUT_PER_THREAD}")
    elif d % 16 or d > MAX_HEAD_DIM or rows * d > VERIFY_MAX_ROWS_D:
        raise ValueError(f"head_dim {d} x group {hq // hkv} x {tokens} tokens: "
                         f"the verify kernels take D a multiple of 16 up to "
                         f"{MAX_HEAD_DIM} with group * T * D <= "
                         f"{VERIFY_MAX_ROWS_D} (their int64 partials in "
                         f"shared memory)")
    if block_table is not None and (block_table.dim() != 2
                                    or block_table.shape[0] != b):
        raise ValueError(f"block_table {tuple(block_table.shape)} for {b} slots")
    want = (b,) if q.dim() == 3 else (b, tokens)
    for name, t in per_slot.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)}: need {want}")
    if cache_len.shape != (b,) or s_v.numel() != 1:
        raise ValueError("cache_len is per-slot (B,); s_v a scalar")
    if exp_lut.numel() != 256 or recip_lut.numel() != cfg.recip_table_size:
        raise ValueError("LUT sizes do not match the LUTConfig")
    if cfg.exp_frac_bits > MAX_EXP_FRAC_BITS:
        raise ValueError(f"exp_frac_bits {cfg.exp_frac_bits}: the kernels' "
                         f"int32 partial sums need e <= 2^{MAX_EXP_FRAC_BITS}")
    for name, t in (("k_cache", k_pages), ("v_cache", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")


def _launch(name: str, fn_name: str, q, pointers, dims, cfg, window,
            exact_recip, out, instance=()):
    """Launch ``fn_name`` of ``csrc/<name>.cu`` (its ``exact_recip``
    instance when asked; ``instance``, the ints naming a tile instance,
    after it, or in its place for a tile library) on PyTorch's current
    stream; raises on a refused launch."""
    lib = _lib(name)
    flags = (() if name.startswith("splitmax_verify_tiles")
             else (int(exact_recip),)) + tuple(instance)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(
            *(t.data_ptr() for t in pointers), out.data_ptr(), *dims,
            window or 0, cfg.recip_index_bits, cfg.recip_frac_bits,
            *flags, stream)
    if err:
        raise RuntimeError(f"{fn_name} failed: "
                           + getattr(lib, f"{name}_error_string")(err).decode())


def _instance(kind: str, block_k, g_pad_min, s_max, exact_recip
              ) -> Tuple[int, int]:
    """The wrapper's ``(stage, row_pad)`` (:func:`tile_instance`); raises
    for a tile instance with ``exact_recip``, which has none."""
    stage, row_pad = tile_instance(block_k, g_pad_min, s_max)
    if kind.startswith("decode"):
        row_pad = 16                   # the decode pads no rows
    if (stage, row_pad) != (0, 16) and exact_recip:
        raise ValueError(f"tile (block_k {block_k}, g_pad_min {g_pad_min}): "
                         f"no compiled exact_recip instance")
    return stage, row_pad


def _count_tile(kind: str, stage: int, row_pad: int) -> None:
    if (stage, row_pad) != (0, 16):
        key = (kind, stage, row_pad)
        tile_launches[key] = tile_launches.get(key, 0) + 1


def splitmax_decode_fused_paged_cuda(q, k_pages, v_pages, block_table, m_z,
                                     s_q, s_v, cache_len, exp_lut, recip_lut,
                                     *, cfg: LUTConfig,
                                     window: Optional[int] = None,
                                     exact_recip: bool = False
                                     ) -> torch.Tensor:
    """Launch the fused decode kernel; raises on bad input or a refused
    launch.  ``q`` is f32; table ids must lie in the pool (the scheduler's
    allocator guarantees it)."""
    global launches
    if not q.is_cuda:
        raise ValueError("splitmax_decode_fused_paged_cuda takes CUDA tensors")
    if q.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)}: need (B, Hq, D)")
    _check(q, torch.float32, {"m_z": m_z, "s_q": s_q}, k_pages, v_pages,
           block_table, s_v, cache_len, exp_lut, recip_lut, cfg, window,
           tokens=1, threads=THREADS)
    b, hq, d = q.shape
    _, hkv, bk, _ = k_pages.shape
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    _launch("splitmax_decode", "splitmax_decode_fused_paged_launch", q,
            (q, k_pages, v_pages, block_table, m_z, s_q, s_v, cache_len,
             exp_lut, recip_lut),
            (b, hq, hkv, d, bk, block_table.shape[1]), cfg, window,
            exact_recip, out)
    launches += 1
    return out


def splitmax_decode_paged_cuda(q_q, k_pages, v_pages, block_table, m_z, s_v,
                               cache_len, exp_lut, recip_lut, *,
                               cfg: LUTConfig,
                               window: Optional[int] = None,
                               exact_recip: bool = False) -> torch.Tensor:
    """Launch the composed decode kernel (int8 ``q_q``, no in-kernel
    quantize); raises on bad input or a refused launch."""
    global composed_launches
    if not q_q.is_cuda:
        raise ValueError("splitmax_decode_paged_cuda takes CUDA tensors")
    if q_q.dim() != 3:
        raise ValueError(f"q_q {tuple(q_q.shape)}: need (B, Hq, D)")
    _check(q_q, torch.int8, {"m_z": m_z}, k_pages, v_pages, block_table, s_v,
           cache_len, exp_lut, recip_lut, cfg, window, tokens=1,
           threads=THREADS)
    b, hq, d = q_q.shape
    _, hkv, bk, _ = k_pages.shape
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q_q.device)
    if out.numel() == 0:
        return out
    _launch("splitmax_decode", "splitmax_decode_paged_launch", q_q,
            (q_q, k_pages, v_pages, block_table, m_z, s_v, cache_len,
             exp_lut, recip_lut),
            (b, hq, hkv, d, bk, block_table.shape[1]), cfg, window,
            exact_recip, out)
    composed_launches += 1
    return out


def splitmax_decode_fused_verify_paged_cuda(q, k_pages, v_pages, block_table,
                                            m_z, s_q, s_v, cache_len,
                                            exp_lut, recip_lut, *,
                                            cfg: LUTConfig,
                                            window: Optional[int] = None,
                                            exact_recip: bool = False,
                                            g_pad_min: int = 8
                                            ) -> torch.Tensor:
    """Launch the fused verify kernel: f32 ``q (B, Hq, T, D)``, ``m_z`` and
    ``s_q`` per (slot, token) ``(B, T)``, ``cache_len`` counting all T
    tokens; ``g_pad_min`` 16 launches the instance whose query rows are
    padded to 32.  Raises on bad input or a refused launch."""
    global verify_launches
    if not q.is_cuda:
        raise ValueError("splitmax_decode_fused_verify_paged_cuda takes CUDA "
                         "tensors")
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}: need (B, Hq, T, D)")
    b, hq, t, d = q.shape
    _check(q, torch.float32, {"m_z": m_z, "s_q": s_q}, k_pages, v_pages,
           block_table, s_v, cache_len, exp_lut, recip_lut, cfg, window,
           tokens=t, threads=None)
    _, hkv, bk, _ = k_pages.shape
    _, row_pad = _instance("verify_paged", None, g_pad_min, 0, exact_recip)
    out = torch.empty((b, hq, t, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib, fn_name, inst = (
        ("splitmax_verify", "splitmax_verify_paged_launch", ())
        if row_pad == 16 else
        ("splitmax_verify_tiles_pad", "splitmax_verify_tile_paged_launch",
         (row_pad,)))
    _launch(lib, fn_name, q,
            (q, k_pages, v_pages, block_table, m_z, s_q, s_v, cache_len,
             exp_lut, recip_lut),
            (b, hq, hkv, t, d, bk, block_table.shape[1]), cfg, window,
            exact_recip, out, inst)
    verify_launches += 1
    _count_tile("verify_paged", 0, row_pad)
    return out


def splitmax_decode_fused_cuda(q, k_cache, v_cache, m_z, s_q, s_v, cache_len,
                               exp_lut, recip_lut, *, cfg: LUTConfig,
                               window: Optional[int] = None,
                               exact_recip: bool = False,
                               block_k: Optional[int] = None,
                               g_pad_min: int = 8) -> torch.Tensor:
    """Launch the fused dense decode kernel: f32 ``q (B, Hq, D)`` against
    the dense cache ``(B, Hkv, S_max, D)``, the instance of the tile
    ``(block_k, g_pad_min)`` (:func:`tile_instance`; the decode pads no
    rows, so ``g_pad_min`` picks nothing); raises on bad input, a tile
    with no instance or a refused launch."""
    global dense_launches
    if not q.is_cuda:
        raise ValueError("splitmax_decode_fused_cuda takes CUDA tensors")
    if q.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)}: need (B, Hq, D)")
    _check(q, torch.float32, {"m_z": m_z, "s_q": s_q}, k_cache, v_cache, None,
           s_v, cache_len, exp_lut, recip_lut, cfg, window, tokens=1,
           threads=THREADS)
    b, hq, d = q.shape
    _, hkv, s_max, _ = k_cache.shape
    stage, _ = _instance("decode", block_k, g_pad_min, s_max, exact_recip)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    _launch("splitmax_decode", "splitmax_decode_fused_dense_launch", q,
            (q, k_cache, v_cache, m_z, s_q, s_v, cache_len, exp_lut,
             recip_lut), (b, hq, hkv, d, DENSE_BLOCK_K, s_max), cfg, window,
            exact_recip, out, (stage,))
    dense_launches += 1
    _count_tile("decode", stage, 16)
    return out


def splitmax_decode_cuda(q_q, k_cache, v_cache, m_z, s_v, cache_len, exp_lut,
                         recip_lut, *, cfg: LUTConfig,
                         window: Optional[int] = None,
                         exact_recip: bool = False,
                         block_k: Optional[int] = None,
                         g_pad_min: int = 8) -> torch.Tensor:
    """Launch the composed dense decode kernel (int8 ``q_q``, no in-kernel
    quantize), the instance of the tile ``(block_k, g_pad_min)`` as
    :func:`splitmax_decode_fused_cuda`; raises on bad input, a tile with
    no instance or a refused launch."""
    global dense_composed_launches
    if not q_q.is_cuda:
        raise ValueError("splitmax_decode_cuda takes CUDA tensors")
    if q_q.dim() != 3:
        raise ValueError(f"q_q {tuple(q_q.shape)}: need (B, Hq, D)")
    _check(q_q, torch.int8, {"m_z": m_z}, k_cache, v_cache, None, s_v,
           cache_len, exp_lut, recip_lut, cfg, window, tokens=1,
           threads=THREADS)
    b, hq, d = q_q.shape
    _, hkv, s_max, _ = k_cache.shape
    stage, _ = _instance("decode_composed", block_k, g_pad_min, s_max,
                         exact_recip)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q_q.device)
    if out.numel() == 0:
        return out
    _launch("splitmax_decode", "splitmax_decode_dense_launch", q_q,
            (q_q, k_cache, v_cache, m_z, s_v, cache_len, exp_lut, recip_lut),
            (b, hq, hkv, d, DENSE_BLOCK_K, s_max), cfg, window,
            exact_recip, out, (stage,))
    dense_composed_launches += 1
    _count_tile("decode_composed", stage, 16)
    return out


def splitmax_decode_fused_verify_cuda(q, k_cache, v_cache, m_z, s_q, s_v,
                                      cache_len, exp_lut, recip_lut, *,
                                      cfg: LUTConfig,
                                      window: Optional[int] = None,
                                      exact_recip: bool = False,
                                      block_k: Optional[int] = None,
                                      g_pad_min: int = 8) -> torch.Tensor:
    """Launch the dense verify kernel: f32 ``q (B, Hq, T, D)``, ``m_z`` and
    ``s_q`` per (slot, token) ``(B, T)``, ``cache_len`` counting all T
    tokens; the instance of the tile ``(block_k, g_pad_min)``
    (:func:`tile_instance`).  Raises on bad input, a tile with no
    instance or a refused launch."""
    global dense_verify_launches
    if not q.is_cuda:
        raise ValueError("splitmax_decode_fused_verify_cuda takes CUDA tensors")
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}: need (B, Hq, T, D)")
    b, hq, t, d = q.shape
    _check(q, torch.float32, {"m_z": m_z, "s_q": s_q}, k_cache, v_cache, None,
           s_v, cache_len, exp_lut, recip_lut, cfg, window, tokens=t,
           threads=None)
    _, hkv, s_max, _ = k_cache.shape
    stage, row_pad = _instance("verify", block_k, g_pad_min, s_max,
                               exact_recip)
    if stage == 0 and row_pad != 16:
        raise ValueError(f"tile (block_k {block_k}, g_pad_min {g_pad_min}): "
                         f"no compiled dense verify instance")
    out = torch.empty((b, hq, t, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib, fn_name, inst = (
        ("splitmax_verify", "splitmax_verify_dense_launch", ())
        if stage == 0 else
        (TILE_LIBS[row_pad], "splitmax_verify_tile_dense_launch",
         (stage, row_pad)))
    _launch(lib, fn_name, q,
            (q, k_cache, v_cache, m_z, s_q, s_v, cache_len, exp_lut,
             recip_lut), (b, hq, hkv, t, d, DENSE_BLOCK_K, s_max), cfg, window,
            exact_recip, out, inst)
    dense_verify_launches += 1
    _count_tile("verify", stage, row_pad)
    return out
