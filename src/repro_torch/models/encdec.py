"""Encoder-decoder model, the seamless-m4t-medium backbone (port of
``repro/models/encdec.py``).

All three of CIMple's transformer mappings run through the int8 kernels:

  * encoder       -- bidirectional full-sequence attention (kernel 1 with
                     ``causal=False``);
  * decoder self  -- causal attention, its int8 K/V in a cache (kernel 1 at
                     the prefill, the decode kernels after);
  * decoder cross -- K/V from the encoder memory, quantized once per
                     admission and read-only after, queries streamed
                     (kernel 1 non-causal over ``S_enc`` keys at the
                     prefill, the decode kernels after).

The speech frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings ``(B, S_enc, d_model)``.

Parameters are a plain dict laid out like the reference's, except that its
stacked ``encoder`` and ``decoder`` leaves are one Python list of
per-layer dicts each (:mod:`repro_torch.bridge` maps between the two).  The
LM head is always the embedding table, in f32.  Two cache layouts:

  * dense (:func:`make_cache`, :func:`prefill`, :func:`decode_step`): the
    self K/V in a ``(L, B, Hkv, max_len, hd)`` int8 cache, the cross K/V in
    ``(L, B, Hkv, S_enc, hd)``;
  * paged (:func:`make_paged_cache`, :func:`prefill_paged`,
    :func:`decode_step_paged`): the self K/V in the dynamic blocks of the
    int8 pool, the cross K/V in a region carved out of the *same* pool
    (``paged_kv.BlockAllocator.carve``), addressed by its own table
    ``cross_table (slots, cross_bps)`` and with its own per-layer scales.

Caches are updated **in place**; each entry point returns the cache for
symmetry with the reference's functional API.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import attention as core_attn
from repro_torch.core import paged_kv
from repro_torch.core import quantization as qlib
from repro_torch.dist.sharding import shard
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

Params = Dict


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                serving: bool = False) -> Params:
    """Random parameters from a seeded ``torch.Generator`` with the
    reference's initializer scales, drawn leaf by leaf on ``device``: f32
    masters, or with ``serving=True`` each linear weight cast to the
    compute dtype as soon as it is drawn (equal to
    ``cast_for_serving(init_params(...))``).  The embedding table is the
    f32 LM head too and stays f32.  With ``cfg.serve_param_dtype ==
    "int8"`` each layer and the table are drawn in f32 and quantized at
    once in the draws' own storage, as :func:`cast_for_serving` would."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    int8 = serving and cfg.int8_weights
    wdt = cfg.compute_dtype if serving and not int8 else torch.float32
    d = cfg.d_model
    norm_init = L.NORM_INIT[cfg.norm]

    def served(tree):
        return qlib.quantize_weights_for_serving(tree, consume=True) \
            if int8 else tree

    def attn():
        return A.attn_block_init(gen, cfg, device=dev, dtype=wdt)

    def mlp():
        return M.mlp_init(gen, cfg, device=dev, dtype=wdt)

    p: Params = {"embed": served(L.embedding_init(
        gen, L.pad_vocab(cfg.vocab_size, cfg.vocab_pad_multiple), d,
        device=dev))}
    p["encoder"] = [served({"norm1": norm_init(d, dev), "attn": attn(),
                            "norm2": norm_init(d, dev), "mlp": mlp()})
                    for _ in range(cfg.n_encoder_layers or cfg.n_layers)]
    p["enc_norm"] = norm_init(d, dev)
    p["decoder"] = [served({"norm1": norm_init(d, dev), "self_attn": attn(),
                            "norm2": norm_init(d, dev), "cross_attn": attn(),
                            "norm3": norm_init(d, dev), "mlp": mlp()})
                    for _ in range(cfg.n_layers)]
    p["final_norm"] = norm_init(d, dev)
    return p


def cast_for_serving(params: Params, cfg: ModelConfig) -> Params:
    """The linear weights cast to the compute dtype once (each layer casts
    them at use, so results are unchanged); the embedding table (the f32
    head) and the norms stay f32, a leaf already cast is kept.  With
    ``cfg.serve_param_dtype == "int8"`` the float linear weights and the
    table are quantized instead (``quantize_weights_for_serving``, meant
    for f32 masters); int8 leaves are kept."""
    if cfg.int8_weights:
        return qlib.quantize_weights_for_serving(params)
    dt = cfg.compute_dtype

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else
                v.to(dt) if k == "w" else v for k, v in tree.items()}

    return dict(params, encoder=[cast(lp) for lp in params["encoder"]],
                decoder=[cast(lp) for lp in params["decoder"]])


# ---------------------------------------------------------------------------
# encoder and teacher-forced decoder
# ---------------------------------------------------------------------------

def _unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm and the tied f32 head -> logits over the padded vocab."""
    logits = L.unembed_apply(params["embed"],
                             L.NORM_APPLY[cfg.norm](params["final_norm"], x))
    return shard(logits, "batch", None, "vocab")


def _run(body, lp, x: torch.Tensor, cfg: ModelConfig, serve: bool):
    """One block; in training under ``torch.utils.checkpoint`` with
    ``cfg.remat`` (the reference's ``jax.checkpoint``)."""
    if cfg.remat and not serve:
        return checkpoint(functools.partial(body, lp), x, use_reentrant=False,
                          preserve_rng_state=False)
    return body(lp, x)


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *,
           serve: bool = False) -> torch.Tensor:
    """frames (B, S_enc, d_model) -> the encoder memory (B, S_enc,
    d_model) in the compute dtype: bidirectional attention in
    ``cfg.attn_mode``, or with ``serve`` in ``cfg.serve_attn_mode``."""
    norm = L.NORM_APPLY[cfg.norm]
    spec = cfg.attn_spec(serve=serve)

    def body(lp, x):
        h = norm(lp["norm1"], x)
        x = x + A.attn_block_apply(lp["attn"], h, cfg, spec=spec,
                                   causal=False)
        h = norm(lp["norm2"], x)
        return shard(x + M.mlp_apply(lp["mlp"], h, cfg), "batch", None,
                     "embed")

    x = shard(frames.to(cfg.compute_dtype), "batch", None, "embed")
    for lp in params["encoder"]:
        x = _run(body, lp, x, cfg, serve)
    return norm(params["enc_norm"], x)


def decode_sequence(params, tokens: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig, *, serve: bool = False
                    ) -> Tuple[torch.Tensor, Dict]:
    """Teacher-forced decoder pass: tokens (B, S) over ``memory`` -> f32
    logits (B, S, vocab_padded) and ``aux``; with ``serve``, ``aux`` holds
    each layer's raw ``self_kv`` (B, Hkv, S, hd) and ``cross_kv`` (B, Hkv,
    S_enc, hd) pairs for the caches.  The cross K/V are computed once a
    layer and feed both the cross attention and ``cross_kv`` (the
    reference computes them twice, to the same values)."""
    norm = L.NORM_APPLY[cfg.norm]
    spec = cfg.attn_spec(serve=serve)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    aux: Dict = {"self_kv": [], "cross_kv": []} if serve else {}

    def body(lp, x):
        h = norm(lp["norm1"], x)
        if serve:
            q, k, v = A._project_qkv(lp["self_attn"], h, cfg, positions)
            o = core_attn.attention(q, k, v, spec)
            o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
            x = x + A.out_proj(lp["self_attn"], o, cfg)
            aux["self_kv"].append((k, v))
            kv = A.cross_kv(lp["cross_attn"], memory, cfg)
            aux["cross_kv"].append(kv)
        else:
            x = x + A.attn_block_apply(lp["self_attn"], h, cfg, spec=spec)
            kv = None
        h = norm(lp["norm2"], x)
        x = x + A.cross_attn_apply(lp["cross_attn"], h, memory, cfg,
                                   spec=spec, kv=kv)
        h = norm(lp["norm3"], x)
        return shard(x + M.mlp_apply(lp["mlp"], h, cfg), "batch", None,
                     "embed")

    x = shard(L.embedding_apply(params["embed"], tokens,
                                dtype=cfg.compute_dtype),
              "batch", None, "embed")
    for lp in params["decoder"]:
        x = _run(body, lp, x, cfg, serve)
    return _unembed(params, x, cfg), aux


def forward(params, batch: Dict, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict]:
    """Training forward: ``batch = {"frames", "tokens"}`` -> (f32 logits,
    ``aux`` with zero ``aux_loss`` and ``z_loss``)."""
    memory = encode(params, batch["frames"], cfg)
    logits, _ = decode_sequence(params, batch["tokens"], memory, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, {"aux_loss": zero, "z_loss": zero}


def _prefill_kv(params, frames, tokens, cfg):
    """Encode and run the decoder in serve mode: (logits, self K, self V,
    cross K, cross V), each K/V stacked by layer (L, B, Hkv, S, hd)."""
    memory = encode(params, frames, cfg, serve=True)
    logits, aux = decode_sequence(params, tokens, memory, cfg, serve=True)
    stack = [torch.stack([kv[i] for kv in aux[name]])
             for name in ("self_kv", "cross_kv") for i in (0, 1)]
    return (logits, *stack)


# ---------------------------------------------------------------------------
# one decoder token against the caches
# ---------------------------------------------------------------------------

def _decode_layers(params, token: torch.Tensor, cfg: ModelConfig,
                   self_block, self_cache, cross_attend) -> torch.Tensor:
    """token (B,) -> logits (B, vocab_padded): per layer the self-attention
    decode block ``self_block`` on ``self_cache(i)``, then one cross query
    per slot through ``cross_attend(i, q (B, Hq, hd))``."""
    norm = L.NORM_APPLY[cfg.norm]
    dt = cfg.compute_dtype
    b = token.shape[0]
    x = L.embedding_apply(params["embed"], token[:, None], dtype=dt)
    for i, lp in enumerate(params["decoder"]):
        h = norm(lp["norm1"], x)
        x = x + self_block(lp["self_attn"], h, self_cache(i), cfg)
        h = norm(lp["norm2"], x)
        p = lp["cross_attn"]
        q = L.linear_apply(p["wq"], h, dtype=dt).reshape(b, cfg.n_heads,
                                                          cfg.hd)
        out = cross_attend(i, q).reshape(b, 1, cfg.n_heads * cfg.hd)
        x = x + L.linear_apply(p["wo"], out, dtype=dt)
        h = norm(lp["norm3"], x)
        x = x + M.mlp_apply(lp["mlp"], h, cfg)
    return _unembed(params, x, cfg)[:, 0]


# ---------------------------------------------------------------------------
# dense cache: the self K/V in (slots, max_len) rows, the cross K/V beside
# ---------------------------------------------------------------------------

def make_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int, *,
               device="cuda") -> Dict:
    """The self-KV cache (``attention.init_kv_cache``), the int8 cross K/V
    ``(L, batch, Hkv, enc_len, hd)`` with per-layer scales, and lengths."""
    dev = resolve_device(device)
    nl = cfg.n_layers
    shape = (nl, batch, cfg.n_kv_heads, enc_len, cfg.hd)
    return {
        "self_kv": A.init_kv_cache(cfg, batch, max_len, device=dev),
        "cross_k_q": torch.zeros(shape, dtype=torch.int8, device=dev),
        "cross_v_q": torch.zeros(shape, dtype=torch.int8, device=dev),
        "cross_scale_k": torch.full((nl, 1, 1, 1, 1), 1e-2,
                                    dtype=torch.float32, device=dev),
        "cross_scale_v": torch.full((nl, 1, 1, 1, 1), 1e-2,
                                    dtype=torch.float32, device=dev),
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def prefill(params, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Encode ``frames`` and prefill ``tokens (B, S)``: both caches filled
    and calibrated batch-wide; returns the last position's logits."""
    b, s = tokens.shape
    logits, k_s, v_s, kc, vc = _prefill_kv(params, frames, tokens, cfg)
    skv = cache["self_kv"]
    for holder, x, q_name, s_name in (
            (skv, k_s, "k_q", "scale_k"), (skv, v_s, "v_q", "scale_v"),
            (cache, kc, "cross_k_q", "cross_scale_k"),
            (cache, vc, "cross_v_q", "cross_scale_v")):
        holder[s_name].copy_(qlib.absmax_scale(x, axis=(1, 2, 3, 4)))
        holder[q_name][:, :, :, :x.shape[3]] = qlib.quantize(x, holder[s_name])
    skv["length"].fill_(s)
    cache["length"].fill_(s)
    return logits[:, -1], cache


def decode_step(params, token: torch.Tensor, cfg: ModelConfig, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One decoder token per slot against the dense self cache (its K/V
    written in place) and the static cross K/V: the dense decode kernels
    (4, or 6 with ``attn_fused=False``) for both attentions."""
    spec = cfg.attn_spec(serve=True)
    skv = cache["self_kv"]
    enc_len = cache["cross_k_q"].shape[3]
    cross_len = torch.full(token.shape, enc_len, dtype=torch.int32,
                           device=token.device)

    def cross(i, q):
        return core_attn.decode_attention(
            q, cache["cross_k_q"][i], cache["cross_v_q"][i],
            cache["cross_scale_k"][i].reshape(()),
            cache["cross_scale_v"][i].reshape(()), cross_len, spec)

    logits = _decode_layers(params, token, cfg, A.attn_block_decode,
                            lambda i: T._layer_cache(skv, i), cross)
    skv["length"] += 1
    cache["length"] += 1
    return logits, cache


# ---------------------------------------------------------------------------
# paged serving: the self K/V in the dynamic blocks, the cross K/V in a
# carved write-once region of the same pool
# ---------------------------------------------------------------------------

def make_paged_cache(cfg: ModelConfig, slots: int, max_len: int, *,
                     block_k: int, num_blocks: int, cross_table,
                     enc_len: int, device="cuda") -> Dict:
    """``kv``: the paged int8 pool over the decoder layers
    (``paged_kv.init_kv_pages``, ``num_blocks`` blocks), whose carved ids
    ``cross_table (slots, cross_bps)`` hold each slot's cross K/V;
    per-layer cross scales; ``cross_len``, the encoder length every slot
    attends over (idle ones too); lengths."""
    dev = resolve_device(device)
    nl = cfg.n_layers
    bps = paged_kv.blocks_per_seq(max_len, block_k)
    return {
        "kv": paged_kv.init_kv_pages(nl, num_blocks, cfg.n_kv_heads, block_k,
                                     cfg.hd, slots, bps, device=dev),
        "cross_table": torch.as_tensor(np.asarray(cross_table),
                                       dtype=torch.int32, device=dev),
        "cross_scale_k": torch.full((nl, 1, 1, 1, 1), 1e-2,
                                    dtype=torch.float32, device=dev),
        "cross_scale_v": torch.full((nl, 1, 1, 1, 1), 1e-2,
                                    dtype=torch.float32, device=dev),
        "cross_len": torch.full((slots,), enc_len, dtype=torch.int32,
                                device=dev),
        "length": torch.zeros((slots,), dtype=torch.int32, device=dev),
    }


def prefill_paged(params, frames: torch.Tensor, tokens: torch.Tensor,
                  cfg: ModelConfig, cache: Dict, slot_ids: torch.Tensor,
                  block_ids: torch.Tensor, *, calibrate: bool = False
                  ) -> Tuple[torch.Tensor, Dict]:
    """Per-slot admission: encode ``frames``, prefill ``tokens (B, S)`` and
    write the named slots' self K/V into the leading ``ceil(S / block_k)``
    of ``block_ids (B, blocks_per_slot)`` and their cross K/V into their
    carved rows of ``cross_table``.  ``calibrate`` (the first admission)
    fixes all four pool scales from this batch; later admissions quantize
    with them."""
    b, s = tokens.shape
    logits, k_s, v_s, kc, vc = _prefill_kv(params, frames, tokens, cfg)
    kvc = cache["kv"]
    mb = kvc["block_table"].shape[1]
    n_blk = paged_kv.blocks_per_seq(s, kvc["k_pages"].shape[3])
    if block_ids.shape[1] != mb or n_blk > mb:
        raise ValueError(f"block_ids {tuple(block_ids.shape)} for a prompt "
                         f"of {s} tokens and a table of width {mb}")
    slots = slot_ids.long()
    T.write_prompt_kv(kvc, k_s, v_s, block_ids[:, :n_blk],
                      calibrate=calibrate)
    bank = {"k_pages": kvc["k_pages"], "v_pages": kvc["v_pages"],
            "scale_k": cache["cross_scale_k"],
            "scale_v": cache["cross_scale_v"]}
    T.write_prompt_kv(bank, kc, vc, cache["cross_table"][slots],
                      calibrate=calibrate)
    kvc["block_table"][slots] = block_ids.to(torch.int32)
    kvc["length"][slots] = s
    cache["length"][slots] = s
    return logits[:, s - 1], cache


def decode_step_paged(params, token: torch.Tensor, cfg: ModelConfig,
                      cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decoder token per slot: paged self attention (the tail-block
    write in place, then the decode kernel over the slot's table row) and
    cross attention over the slot's carved rows, read after the same
    layer's self-KV write into the same pool tensors.  Both run the paged
    decode kernel (2, or 5 with ``attn_fused=False``)."""
    spec = cfg.attn_spec(serve=True)
    kvc = cache["kv"]

    def cross(i, q):
        return core_attn.paged_decode_attention(
            q, kvc["k_pages"][i], kvc["v_pages"][i], cache["cross_table"],
            cache["cross_scale_k"][i].reshape(()),
            cache["cross_scale_v"][i].reshape(()), cache["cross_len"], spec)

    logits = _decode_layers(params, token, cfg, A.attn_block_decode_paged,
                            lambda i: T._layer_cache(kvc, i), cross)
    kvc["length"] += 1
    cache["length"] += 1
    return logits, cache
