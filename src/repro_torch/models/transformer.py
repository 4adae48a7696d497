"""Decoder assembly for training and int8 serving: the dense, MoE, SSM and
hybrid families (port of ``repro/models/transformer.py``).

Parameters are a plain dict laid out like the reference's, except that the
scanned layer segments are one Python list of per-layer dicts, each with
an ``mlp`` (dense block), a ``moe`` (MoE block) or an ``ssm`` (Mamba
block) entry, and that the hybrid's ``(groups, per, ...)`` stacked Mamba-2
layers are the same flat list beside its ``shared_attn`` block
(:mod:`repro_torch.bridge` maps between the layouts).  Two cache layouts,
told apart by their keys: the paged pool (``k_pages``, from
:func:`make_paged_cache`; dense and MoE) and the dense ``(slots,
max_len)`` cache (``k_q``, from :func:`make_cache`).  An SSM or hybrid
dense cache carries each layer's float state in the same dict: ``conv``
``(L, B, d_conv-1, C)`` in the compute dtype and ``h`` ``(L, B, di, N)``
(Mamba-1) or ``(L, B, H, N, P)`` (Mamba-2) in f32, beside the hybrid's
int8 K/V of its ``L / hybrid_attn_every`` shared-attention calls (the
SSM engine keeps the state int8 instead: ``launch/engines/ssm.py``).
Entry points:

  * :func:`forward` — full-sequence logits: training mode (QAT attention,
    per-block remat, the MoE aux losses) or serve mode (the prefills'
    forward, returning the attention layers' K/V and the SSM states);
  * :func:`prefill` — run the whole batch, calibrate and fill a dense
    cache, return each row's last valid logits;
  * :func:`prefill_paged` — run a prompt, write its int8 K/V into the named
    slots' pool blocks, return last-position logits (per-slot admission);
  * :func:`decode_step` — one token per slot in, logits out, on either
    layout;
  * :func:`verify_step` — T tokens per slot in, logits for each out
    (speculative verify, paged).

The cache dict is updated **in place**; each returns it for symmetry with
the reference's functional API.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, trace
from repro_torch.core import attention as core_attn
from repro_torch.core import paged_kv
from repro_torch.core import quantization as qlib
from repro_torch.dist.sharding import remat_context, shard
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

Params = Dict


def layer_segments(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(kind, count) segments, in order: the reference's ``_layer_kinds``,
    its stacked segments (a MoE config's leading dense layers, then its MoE
    layers; an SSM config's Mamba layers), and the hybrid's Mamba-2
    layers."""
    if cfg.family == "dense":
        return [("dense", cfg.n_layers)]
    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        return ([("dense", fd)] if fd else []) + [("moe", cfg.n_layers - fd)]
    if cfg.family in ("ssm", "hybrid"):
        if cfg.ssm is None or cfg.ssm.kind not in S.MAMBA_INIT:
            raise ValueError(f"{cfg.name}: the {cfg.family} family needs an "
                             f"SSMConfig of kind mamba1 or mamba2")
        if cfg.family == "hybrid" and cfg.n_layers % cfg.hybrid_attn_every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers in groups "
                             f"of {cfg.hybrid_attn_every}")
        return [(cfg.ssm.kind, cfg.n_layers)]
    raise NotImplementedError(
        f"{cfg.name}: this decoder holds the dense, MoE, SSM and hybrid "
        f"families; the {cfg.family} family is models.encdec")


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                serving: bool = False) -> Params:
    """Random parameters from a seeded ``torch.Generator``, with the
    reference's initializer scales (the values differ from
    ``jax.random``'s; bridge JAX parameters with :mod:`repro_torch.bridge`
    to compare).

    float32 masters by default.  ``serving=True`` casts each leaf that
    :func:`cast_for_serving` casts as soon as it is drawn, before the next
    draw: the result equals ``cast_for_serving(init_params(...))`` bit for
    bit, and the device never holds more than one f32 leaf beyond it
    (DeepSeekMoE-16B's f32 masters alone are 65.5 GB).  With
    ``cfg.serve_param_dtype == "int8"`` each layer, the table and the head
    are drawn in f32 and passed at once through :func:`cast_for_serving`'s
    policy (:func:`_serve_subtree`), which quantizes them in the draws' own
    storage (DeepSeek-67B: 67.4 GB in int8; its largest f32 draw is the
    3.4 GB head, a layer's is 2.8 GB).
    """
    segments = layer_segments(cfg)
    dev = resolve_device(device)
    if serving:
        _require_servable(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    int8 = serving and cfg.int8_weights
    wdt = cfg.compute_dtype if serving and not int8 else torch.float32

    def served(tree):
        return _serve_subtree(tree, cfg, consume=True) if int8 else tree

    vp = L.pad_vocab(cfg.vocab_size, cfg.vocab_pad_multiple)
    norm_init = L.NORM_INIT[cfg.norm]
    # a tied table is also the f32 LM head: it stays f32 when served
    p: Params = {"embed": served(L.embedding_init(
        gen, vp, cfg.d_model, device=dev,
        dtype=torch.float32 if cfg.tie_embeddings else wdt))}

    def layer(kind):
        lp = {"norm1": norm_init(cfg.d_model, dev)}
        if kind in S.MAMBA_INIT:
            lp["ssm"] = S.MAMBA_INIT[kind](gen, cfg, device=dev, dtype=wdt)
        else:
            lp["attn"] = A.attn_block_init(gen, cfg, device=dev, dtype=wdt)
            lp["norm2"] = norm_init(cfg.d_model, dev)
        if kind == "dense":
            lp["mlp"] = M.mlp_init(gen, cfg, device=dev, dtype=wdt)
        elif kind == "moe":
            lp["moe"] = MOE.moe_init(gen, cfg, device=dev, dtype=wdt)
        return lp

    # no f32 draw outlives its quantization
    p["layers"] = [served(layer(kind)) for kind, n in segments
                   for _ in range(n)]
    if cfg.family == "hybrid":
        # one attention + MLP block shared by every group, on
        # concat(hidden, embeddings)
        p["shared_attn"] = served({
            "norm": norm_init(2 * cfg.d_model, dev),
            "attn": A.attn_block_init(gen, cfg, device=dev, dtype=wdt,
                                      d_input=2 * cfg.d_model),
            "mlp_norm": norm_init(cfg.d_model, dev),
            "mlp": M.mlp_init(gen, cfg, device=dev, dtype=wdt)})
    p["final_norm"] = norm_init(cfg.d_model, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = served(L.linear_init(gen, cfg.d_model, vp,
                                            device=dev))
    return p


def _require_servable(cfg: ModelConfig, params: Optional[Params] = None
                      ) -> None:
    """Refuse int8 serve weights (``cfg.serve_param_dtype`` or an int8
    ``dt_proj`` in ``params``) for Mamba-1 layers: their step multiplies
    ``dt_proj``'s float ``w`` directly, where the reference dies on a
    ``KeyError: 'w'`` (``repro/models/ssm.py:136``; ROADMAP queue 3)."""
    if cfg.ssm is None or cfg.ssm.kind != "mamba1":
        return
    int8 = cfg.int8_weights or (params is not None and any(
        "w_q" in lp["ssm"]["dt_proj"] for lp in params["layers"]))
    if int8:
        raise ValueError(f"{cfg.name}: the {cfg.family} family's Mamba-1 "
                         f"layers serve with float weights only (dt_proj "
                         f"is multiplied as a float w; the reference fails "
                         f"with a KeyError on int8 serve weights)")


# f32 subtrees a serve step multiplies as stored: the MoE router (routing
# is computed from f32 weights) and Mamba-1's dt projection (it multiplies
# the f32 dt_in)
_F32_SUBTREES = ("router", "dt_proj")


def _serve_subtree(tree: Params, cfg: ModelConfig, *, consume: bool = False
                   ) -> Params:
    """:func:`cast_for_serving` on one layer or shared block (or, for an
    int8 config, the table or the head): the linear weights and tables
    quantized with ``cfg.serve_param_dtype == "int8"`` (``consume``: in
    the f32 leaves' own storage, a serving init's draws), then the float
    leaves a step casts at use cast to the compute dtype."""
    if cfg.int8_weights:
        tree = qlib.quantize_weights_for_serving(tree, consume=consume)
    dt = cfg.compute_dtype

    def cast(tree, stacks=False):
        return {k: (v if k in _F32_SUBTREES else
                    cast(v, stacks=k == "moe") if isinstance(v, dict) else
                    v.to(dt) if k in ("w", "conv_w") or stacks else v)
                for k, v in tree.items()}

    return cast(tree)


def cast_for_serving(params: Params, cfg: ModelConfig) -> Params:
    """Cast the weights each layer casts at use (the linear weights, the
    MoE expert stacks, the Mamba conv weights, an untied embedding table)
    to the compute dtype once, so a step does not re-cast them.  Results
    are unchanged: casting once equals casting at every use.  The MoE
    router, Mamba-1's ``dt_proj``, the SSM's ``A_log``, ``D`` and
    ``dt_bias``, the f32 LM head, a tied table (it is the f32 head too;
    its gathered rows are cast at use) and the norms stay f32; a leaf
    already in the compute dtype is kept, not copied.

    With ``cfg.serve_param_dtype == "int8"`` every float linear weight and
    table (router and head included) is first quantized
    (``quantize_weights_for_serving``, meant for f32 masters); int8 leaves
    are kept as they are, and the MoE expert stacks and conv weights are
    cast as above.  Mamba-1 with int8 weights raises (``ValueError``)."""
    _require_servable(cfg, params)
    embed = params["embed"]
    if cfg.int8_weights:
        embed = _serve_subtree(embed, cfg)
    elif not cfg.tie_embeddings and "table" in embed:
        embed = {"table": embed["table"].to(cfg.compute_dtype)}
    out = {"embed": embed,
           "layers": [_serve_subtree(lp, cfg) for lp in params["layers"]],
           "final_norm": params["final_norm"]}
    if "shared_attn" in params:
        out["shared_attn"] = _serve_subtree(params["shared_attn"], cfg)
    if not cfg.tie_embeddings:
        head = params["lm_head"]
        out["lm_head"] = _serve_subtree(head, cfg) if cfg.int8_weights \
            else head
    return out


def _residual(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The residual stream's placement between blocks (under a mesh
    binding): batch over the data axes, the sequence over "model" with
    ``cfg.seq_sharding``."""
    return shard(x, "batch", "seq" if cfg.seq_sharding else None, "embed")


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    return _residual(L.embedding_apply(params["embed"], tokens,
                                       dtype=cfg.compute_dtype), cfg)


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm and the LM head (tied: the embedding table), in
    ``cfg.logits_dtype`` (f32 when None, the reference's default)."""
    x = L.NORM_APPLY[cfg.norm](params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L.unembed_apply(params["embed"], x, dtype=cfg.head_dtype)
    else:
        logits = L.linear_apply(params["lm_head"], x, dtype=cfg.head_dtype)
    return shard(logits, "batch", None, "vocab")


def _ffn(lp, h: torch.Tensor, cfg: ModelConfig, *, tokenwise: bool = False
         ) -> torch.Tensor:
    """A serve step's second half of a block on its normed input: the
    SwiGLU, or the MoE layer without its aux losses.  ``tokenwise`` (the
    verify step) runs the SwiGLU, and the MoE layer's router and shared
    experts, one token at a time (``layers.per_token``)."""
    if "mlp" in lp:
        if tokenwise:       # int8 weights dequantized once, not per token
            mlp = L.dequantized(lp["mlp"], cfg.compute_dtype,
                                rows=h.shape[0])
            return L.per_token(functools.partial(M.mlp_apply, mlp, cfg=cfg),
                               h)
        return M.mlp_apply(lp["mlp"], h, cfg)
    return MOE.moe_apply(lp["moe"], h, cfg, losses=False,
                         tokenwise=tokenwise)[0]


def _mamba_block(lp, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[Dict] = None):
    """One Mamba block, pre-norm and residual: the new ``x`` and, with a
    ``state`` (decode), the new state."""
    h = L.NORM_APPLY[cfg.norm](lp["norm1"], x)
    out, st = S.MAMBA_APPLY[cfg.ssm.kind](lp["ssm"], h, cfg, state=state)
    return x + out, st


def _mamba_block_serve(lp, x: torch.Tensor, cfg: ModelConfig):
    """A serve-mode Mamba block: run from a zero state, so that the state
    after the sequence comes back for the cache (one pass, no rerun)."""
    x, st = _mamba_block(lp, x, cfg,
                         S.zero_state(cfg, x.shape[0], device=x.device))
    return _residual(x, cfg), st


def _block_apply(lp, x: torch.Tensor, cfg: ModelConfig):
    """One training-mode block (attention in ``cfg.attn_mode``): the new
    ``x`` and, for a MoE block, its (aux_loss, z_loss) stacked (None for a
    dense or Mamba block)."""
    if "ssm" in lp:
        return _residual(_mamba_block(lp, x, cfg)[0], cfg), None
    norm = L.NORM_APPLY[cfg.norm]
    h = norm(lp["norm1"], x)
    x = x + A.attn_block_apply(lp["attn"], h, cfg)
    h = norm(lp["norm2"], x)
    if "mlp" in lp:
        return _residual(x + M.mlp_apply(lp["mlp"], h, cfg), cfg), None
    out, aux = MOE.moe_apply(lp["moe"], h, cfg)
    return (_residual(x + out, cfg),
            torch.stack([aux["aux_loss"], aux["z_loss"]]))


def _attn_serve(attn, h: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """A serve-mode attention (``cfg.serve_attn_mode``) on the normed
    ``h``: its output projection and its raw (k, v) for the cache."""
    b, s, _ = h.shape
    q, k, v = A._project_qkv(attn, h, cfg, positions)
    o = core_attn.attention(q, k, v, cfg.attn_spec(serve=True))
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return A.out_proj(attn, o, cfg), (k, v)


def _block_apply_serve(lp, x: torch.Tensor, cfg: ModelConfig,
                       positions: torch.Tensor):
    """One serve-mode dense or MoE block, returning this layer's raw
    (k, v) for the cache."""
    norm = L.NORM_APPLY[cfg.norm]
    out, kv = _attn_serve(lp["attn"], norm(lp["norm1"], x), cfg, positions)
    x = x + out
    h = norm(lp["norm2"], x)
    return _residual(x + _ffn(lp, h, cfg), cfg), kv


def _remat(fn, lp, x: torch.Tensor, cfg: ModelConfig):
    """``fn(lp, x, cfg)`` under ``torch.utils.checkpoint`` when
    ``cfg.remat``; a MoE block on a mesh keeps its combine's reduce for
    the backward (``sharding.remat_context``)."""
    if cfg.remat:
        ctx = remat_context() if "moe" in lp else None
        kw = {"context_fn": ctx} if ctx is not None else {}
        return checkpoint(functools.partial(fn, lp, cfg=cfg), x,
                          use_reentrant=False, preserve_rng_state=False,
                          **kw)
    return fn(lp, x, cfg)


def _stack_states(states: List[Dict]) -> Dict[str, torch.Tensor]:
    """Per-layer SSM states -> one (L, B, ...) tensor a leaf."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _shared_attn(sp, x: torch.Tensor, x0: torch.Tensor, cfg: ModelConfig,
                 attend):
    """The hybrid's shared attention + MLP block on concat(x, x0), its
    attention ``attend(attn_params, h) -> (out, kv)`` (training, serve or
    decode); returns the new ``x`` and ``kv``.  On a mesh the new ``x``
    takes the residual stream's placement (``_residual``), so the MLP's
    partial sums are reduced here and its cotangent arrives whole: a
    partial one would have DTensor gather the MLP's split hidden features
    in the backward, and a partial ``x`` would reach the Mamba-2 block's
    input projection."""
    norm = L.NORM_APPLY[cfg.norm]
    h = norm(sp["norm"], torch.cat([x, x0], dim=-1))
    out, kv = attend(sp["attn"], h)
    x = x + out
    h = norm(sp["mlp_norm"], x)
    return _residual(x + M.mlp_apply(sp["mlp"], h, cfg), cfg), kv


def _hybrid_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                    serve: bool):
    """Zamba2's layout: [shared attention, then ``hybrid_attn_every``
    Mamba-2 blocks] per group, the shared block re-fed the embeddings
    ``x0``.  Returns (x, the groups' raw (k, v), the layers' states)."""
    x0 = x
    every = cfg.hybrid_attn_every
    if serve:
        positions = torch.arange(x.shape[1], device=x.device)

        def attend(p, h):
            return _attn_serve(p, h, cfg, positions)
    else:
        def attend(p, h):
            return A.attn_block_apply(p, h, cfg), None
    kvs, states = [], []
    for g0 in range(0, cfg.n_layers, every):
        x, kv = _shared_attn(params["shared_attn"], x, x0, cfg, attend)
        kvs.append(kv)
        for lp in params["layers"][g0:g0 + every]:
            if serve:
                x, st = _mamba_block_serve(lp, x, cfg)
                states.append(st)
            else:
                x, _ = _remat(_block_apply, lp, x, cfg)
    return x, kvs, states


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            serve: bool = False) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, S) -> f32 logits (B, S, vocab_padded) and ``aux``.

    Training mode (``serve=False``): attention in ``cfg.attn_mode``, each
    block under ``torch.utils.checkpoint`` when ``cfg.remat``; ``aux``
    holds ``aux_loss`` and ``z_loss`` summed over the MoE layers (zero for
    the other families).  Serve mode: ``cfg.serve_attn_mode``;
    ``aux["kv"]``, each attention layer's (the hybrid: each shared-block
    call's) raw (k, v) (B, Hkv, S, hd) for the cache; and for the SSM and
    hybrid families ``aux["ssm"]``, every layer's state after the sequence
    from zeros, stacked (:func:`_stack_states`).  Its losses stay zero
    (the reference's are discarded by its callers).
    """
    x = embed_tokens(params, tokens, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux: Dict = {"aux_loss": zero, "z_loss": zero}
    if cfg.family == "hybrid":
        x, kvs, states = _hybrid_forward(params, x, cfg, serve=serve)
    elif serve:
        positions = torch.arange(tokens.shape[1], device=x.device)
        kvs, states = [], []
        for i, lp in enumerate(params["layers"]):
            with trace.span("model.layer", i=i):
                if "ssm" in lp:
                    x, st = _mamba_block_serve(lp, x, cfg)
                    states.append(st)
                else:
                    x, kv = _block_apply_serve(lp, x, cfg, positions)
                    kvs.append(kv)
    else:
        for lp in params["layers"]:
            x, losses = _remat(_block_apply, lp, x, cfg)
            if losses is not None:
                aux = {"aux_loss": aux["aux_loss"] + losses[0],
                       "z_loss": aux["z_loss"] + losses[1]}
    if serve:
        if kvs:
            aux["kv"] = kvs
        if states:
            aux["ssm"] = _stack_states(states)
    return unembed(params, x, cfg), aux


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"
               ) -> Dict[str, torch.Tensor]:
    """Dense decode cache: int8 K/V ``(L_attn, batch, Hkv, max_len, hd)``
    of the attention layers (the hybrid: one a group), per-layer scales
    and lengths, and the SSM and hybrid families' float state (``conv``,
    ``h``; see the module docstring).  With a sliding window, ``max_len``
    is the ring's size (the reference's callers pass the window)."""
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe"):
        return A.init_kv_cache(cfg, batch, max_len, device=dev)
    cache = {"length": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.family == "hybrid":
        cache = A.init_kv_cache(
            cfg, batch, max_len, device=dev,
            n_layers=cfg.n_layers // cfg.hybrid_attn_every)
    cache.update(S.init_ssm_state(cfg, batch, cfg.n_layers, device=dev))
    return cache


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            cache: Dict[str, torch.Tensor], *,
            valid_len: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run ``tokens (B, S)`` and fill the dense cache with their int8 K/V;
    returns the logits at each row's ``valid_len - 1`` (B, vocab_padded).

    Calibration is batch-wide, as in the reference: each layer's
    ``scale_k``/``scale_v`` is the absmax over the whole padded batch
    (padding and idle rows included).  A ring cache shorter than the
    prompt keeps the last ``cache_size`` positions, which needs ``S`` to
    be a multiple of ``cache_size`` so that they land at ring indices 0..

    An SSM layer's state is the state after all ``S`` positions, padding
    included, as in the reference: a row shorter than ``S`` continues from
    the state after its ``S - valid_len`` padding tokens (ROADMAP queue 3).
    """
    b, s = tokens.shape
    if valid_len is None:
        valid_len = torch.full((b,), s, dtype=torch.int32,
                               device=tokens.device)
    logits, aux = forward(params, tokens, cfg, serve=True)
    if "kv" in aux:
        kvs = aux["kv"]
        k_all = torch.stack([k for k, _ in kvs])    # (L, B, Hkv, S, hd)
        v_all = torch.stack([v for _, v in kvs])
        cache_size = cache["k_q"].shape[3]
        if cache_size < s:
            if s % cache_size:
                raise ValueError(f"a ring cache of {cache_size} positions "
                                 f"takes a prompt whose length is a "
                                 f"multiple of it, got {s}")
            k_all = k_all[:, :, :, -cache_size:]
            v_all = v_all[:, :, :, -cache_size:]
        w = k_all.shape[3]
        cache["scale_k"].copy_(qlib.absmax_scale(k_all, axis=(1, 2, 3, 4)))
        cache["scale_v"].copy_(qlib.absmax_scale(v_all, axis=(1, 2, 3, 4)))
        cache["k_q"][:, :, :, :w] = qlib.quantize(k_all, cache["scale_k"])
        cache["v_q"][:, :, :, :w] = qlib.quantize(v_all, cache["scale_v"])
    for k, v in aux.get("ssm", {}).items():
        cache[k].copy_(v)
    cache["length"].copy_(valid_len)
    idx = torch.clamp_min(valid_len.to(torch.int64) - 1, 0)
    last = logits[torch.arange(b, device=logits.device), idx]
    return last, cache


def make_paged_cache(cfg: ModelConfig, slots: int, max_len: int, *,
                     block_k: int = 32, num_blocks: Optional[int] = None,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Paged decode cache: int8 KV block pool + per-slot block tables and
    lengths.  The default pool reserves ``ceil(max_len / block_k)`` blocks
    per slot plus the trash block (id 0)."""
    bps = paged_kv.blocks_per_seq(max_len, block_k)
    if num_blocks is None:
        num_blocks = 1 + slots * bps
    return A.init_paged_kv_cache(cfg, num_blocks, slots, bps, block_k,
                                 device=resolve_device(device))


def prefill_paged(params, tokens: torch.Tensor, cfg: ModelConfig,
                  cache: Dict[str, torch.Tensor], slot_ids: torch.Tensor,
                  block_ids: torch.Tensor, *, calibrate: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill ``tokens (B, S)`` into the named slots only.

    ``block_ids (B, blocks_per_slot)`` is each slot's table row from the
    allocator; the prompt's K/V land in its leading ``ceil(S / block_k)``
    blocks.  ``calibrate=True`` (first admission only) sets the pool's
    static per-layer scales from this prompt's absmax; later admissions
    quantize with the existing scales, like decode.  The whole call is a
    ``model.step`` span of kind ``prefill``, each block a ``model.layer``.
    """
    with trace.span("model.step", kind="prefill"):
        b, s = tokens.shape
        logits, aux = forward(params, tokens, cfg, serve=True)
        kvs = aux["kv"]
        block_k = cache["k_pages"].shape[3]
        mb = cache["block_table"].shape[1]
        if block_ids.shape[1] != mb:
            raise ValueError(
                f"block_ids {tuple(block_ids.shape)} vs table width {mb}")
        n_blk = paged_kv.blocks_per_seq(s, block_k)
        if n_blk > mb:
            raise ValueError(
                f"prompt of {s} tokens needs {n_blk} blocks > {mb}")
        k_all = torch.stack([k for k, _ in kvs])    # (L, B, Hkv, S, hd)
        v_all = torch.stack([v for _, v in kvs])
        write_prompt_kv(cache, k_all, v_all, block_ids[:, :n_blk],
                        calibrate=calibrate)
        slots = slot_ids.long()
        cache["block_table"][slots] = block_ids.to(torch.int32)
        cache["length"][slots] = s
        return logits[:, s - 1], cache


def write_prompt_kv(pool: Dict[str, torch.Tensor], k_all: torch.Tensor,
                    v_all: torch.Tensor, block_ids: torch.Tensor, *,
                    calibrate: bool) -> None:
    """Quantize a prompt's K/V ``(L, B, Hkv, S, hd)`` with the pool's
    per-layer ``scale_k``/``scale_v`` (first, with ``calibrate``, set them
    to the absmax of each layer: the padding to whole blocks is zeros and
    moves no absmax) and write them into ``k_pages``/``v_pages`` at the
    blocks ``block_ids (B, ceil(S / block_k))``, in place."""
    s_k, s_v = pool["scale_k"], pool["scale_v"]
    if calibrate:
        s_k.copy_(qlib.absmax_scale(k_all, axis=(1, 2, 3, 4)))
        s_v.copy_(qlib.absmax_scale(v_all, axis=(1, 2, 3, 4)))
    paged_kv.write_blocks(pool["k_pages"], block_ids, qlib.quantize(k_all, s_k))
    paged_kv.write_blocks(pool["v_pages"], block_ids, qlib.quantize(v_all, s_v))


def _layer_cache(cache: Dict[str, torch.Tensor], i: int
                 ) -> Dict[str, torch.Tensor]:
    """Attention layer ``i``'s views of the cache (pool or dense), with the
    shared lengths and, paged, the shared table."""
    shared = ("block_table", "length")
    return {k: (v if k in shared else v[i]) for k, v in cache.items()
            if k not in ("conv", "h")}


def _mamba_decode(lp, x: torch.Tensor, cfg: ModelConfig,
                  cache: Dict[str, torch.Tensor], i: int) -> torch.Tensor:
    """Mamba layer ``i``'s one-token step; its state in ``cache`` is
    replaced in place."""
    x, st = _mamba_block(lp, x, cfg, {"conv": cache["conv"][i],
                                      "h": cache["h"][i]})
    cache["conv"][i].copy_(st["conv"])
    cache["h"][i].copy_(st["h"])
    return x


def decode_step(params, token: torch.Tensor, cfg: ModelConfig,
                cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """token (B,) -> logits (B, vocab_padded); every slot's length grows
    by one.  Paged, idle slots write into the trash block; dense, each slot
    writes its own row (a ring with a window).  A Mamba layer steps its
    state in place; the hybrid's shared block runs before every
    ``hybrid_attn_every`` of them on the group's slice of the dense
    cache.  The whole call is a ``model.step`` span of kind ``decode``,
    each layer a ``model.layer``."""
    with trace.span("model.step", kind="decode"):
        block = (A.attn_block_decode_paged if "k_pages" in cache
                 else A.attn_block_decode)
        norm = L.NORM_APPLY[cfg.norm]
        x = embed_tokens(params, token[:, None], cfg)       # (B, 1, d)
        x0 = x
        for i, lp in enumerate(params["layers"]):
            with trace.span("model.layer", i=i):
                if cfg.family == "hybrid" and i % cfg.hybrid_attn_every == 0:
                    group = _layer_cache(cache, i // cfg.hybrid_attn_every)
                    x, _ = _shared_attn(
                        params["shared_attn"], x, x0, cfg,
                        lambda p, h: (block(p, h, group, cfg), None))
                if "ssm" in lp:
                    x = _mamba_decode(lp, x, cfg, cache, i)
                    continue
                h = norm(lp["norm1"], x)
                x = x + block(lp["attn"], h, _layer_cache(cache, i), cfg)
                h = norm(lp["norm2"], x)
                x = x + _ffn(lp, h, cfg)
        cache["length"] += 1
        return unembed(params, x, cfg)[:, 0], cache


def verify_step(params, tokens: torch.Tensor, cfg: ModelConfig,
                cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Speculative verify: tokens (B, T) -> f32 logits (B, T, vocab_padded).

    The T-token twin of :func:`decode_step`: every layer appends all T
    tokens' K/V through the block table and runs the verify attention with
    per-token lengths, so ``logits[:, t]`` is bit for bit what
    ``decode_step`` gives after accepting ``tokens[:, :t+1]``, whatever
    BLAS sums the products: every float stage that reduces along a row
    runs one token at a time, at the decode step's B rows
    (``layers.per_token``), since a GEMM or a mean may sum in an order
    chosen by the row count (the card's bf16 GEMMs at a long K, the CPU's
    f32 SGEMM at 1 and 2 rows against 8).  These are the norms (the q/k
    norms too), the q, k, v and output projections, the MLP, the MoE
    router and shared experts and the f32 LM head.  The MoE expert GEMMs have the decode step's
    shape while the capacity at T tokens stays at ``top_k`` (see
    ``moe``).  Where that capacity is below T, verify can drop assignments
    that decode keeps, as the reference does.  Every slot's length grows
    by T; the scheduler truncates it to the accepted prefix.
    """
    t = tokens.shape[1]
    norm = L.NORM_APPLY[cfg.norm]
    x = embed_tokens(params, tokens, cfg)               # (B, T, d)
    for i, lp in enumerate(params["layers"]):
        h = L.per_token(functools.partial(norm, lp["norm1"]), x)
        x = x + A.attn_block_verify_paged(lp["attn"], h, _layer_cache(cache, i),
                                          cfg)
        h = L.per_token(functools.partial(norm, lp["norm2"]), x)
        x = x + _ffn(lp, h, cfg, tokenwise=True)
    cache["length"] += t
    # the head's int8 weights dequantized once, not per token
    head = {k: L.dequantized(params[k], cfg.head_dtype, rows=x.shape[0])
            for k in ("final_norm",
                      "embed" if cfg.tie_embeddings else "lm_head")}
    return L.per_token(lambda y: unembed(head, y, cfg), x), cache


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (no vocab padding; the MLP by ``act``,
    norms by kind, the q/k norms not counted, as in the reference); MoE
    ``active_only`` counts the shared and the top-k routed experts.  The
    formulas are the reference's, its approximations included."""
    d, hd = cfg.d_model, cfg.hd
    attn_p = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + hd * cfg.n_heads * d
    mlp_p = d * cfg.d_ff * (3 if cfg.act == "silu" else 2)
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    norm_p = {"rmsnorm": d, "layernorm": 2 * d, "nonparam_ln": 0}[cfg.norm]
    dense_layer = attn_p + mlp_p + 2 * norm_p
    if cfg.family == "dense":
        return embed + cfg.n_layers * dense_layer + norm_p
    if cfg.family == "moe":
        mc = cfg.moe
        routed = 3 * d * mc.d_ff_expert
        n_routed = mc.top_k if active_only else mc.n_experts
        shared = 3 * d * mc.d_ff_expert * mc.n_shared
        router = d * mc.n_experts
        moe_layer = attn_p + routed * n_routed + shared + router + 2 * norm_p
        fd = mc.first_dense_layers
        return (embed + fd * dense_layer + (cfg.n_layers - fd) * moe_layer
                + norm_p)
    if cfg.family == "encdec":
        n_enc = cfg.n_encoder_layers or cfg.n_layers
        dec_layer = 2 * attn_p + mlp_p + 3 * norm_p
        return embed + n_enc * dense_layer + cfg.n_layers * dec_layer \
            + 2 * norm_p
    sc = cfg.ssm
    di, n = cfg.d_inner, sc.d_state
    nh = di // sc.headdim
    mamba2 = (d * (2 * di + 2 * n + nh) + sc.d_conv * (di + 2 * n) + 3 * nh
              + di + di * d)
    if cfg.family == "ssm":
        if sc.kind == "mamba1":
            r = sc.dt_rank or max(d // 16, 1)
            per = (d * 2 * di + sc.d_conv * di + di * (r + 2 * n) + r * di
                   + di + di * n + di + di * d)
        else:
            per = mamba2
        return embed + cfg.n_layers * (per + norm_p) + norm_p
    if cfg.family == "hybrid":
        # the reference counts the shared block's concat-width norm as d
        shared = (2 * d * hd * cfg.n_heads + 2 * d * hd * 2 * cfg.n_kv_heads
                  + hd * cfg.n_heads * d + mlp_p + 3 * norm_p)
        return embed + cfg.n_layers * (mamba2 + norm_p) + shared + norm_p
    raise ValueError(cfg.family)
