"""Mixture-of-Experts with token-choice top-k routing and capacity limits
(port of ``repro/models/moe.py``).

The reference's dense-dispatch formulation, one group per sequence: each
token's f32 router picks its top-k experts, every (token, k) assignment
takes the next slot of its expert's queue in token-major, then k order, an
assignment past the expert's capacity is dropped (its token falls through
the residual), a one-hot dispatch tensor moves the kept tokens into an
``(E, B, C, d)`` batch, the experts run as stacked batched GEMMs, and each
token's output is the gate-weighted sum of its experts' rows.  Shared
experts (deepseek-moe) are one fused SwiGLU of width ``n_shared * d_ff``.

Integer parts (routing indices, queue positions, the dropped set) equal the
reference's; float parts agree within rounding.  Two formulations differ
from the reference's and give the same values:

* the dispatch tensor is scattered, not summed from ``top_k`` one-hots: no
  two assignments of a group share an (expert, slot), so each entry is the
  same 0 or 1;
* the combine gathers each token's ``top_k`` expert rows and sums their
  gate-weighted products in f32, k by k, instead of contracting the whole
  ``(E, C)`` one-hot: the zero terms add nothing, and the elementwise sum
  gives every token the same result whatever the batch's row count or the
  token's queue slot, which the speculative verify needs on the card.

The speculative verify (``tokenwise=True``) runs the router and the shared
experts one token at a time, at the decode step's shape.  The expert GEMMs
have that shape already while the capacity at T tokens stays at its floor
``top_k`` (their rows are the capacity slots; DeepSeekMoE-16B at T = 4).

"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.dist.sharding import kept_for_backward, per_rank, shard
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models.config import ModelConfig, MoEConfig


def moe_init(gen, cfg: ModelConfig, *, device,
             dtype: torch.dtype = torch.float32) -> L.Params:
    """Router, stacked expert weights ``(E, d, dff)`` / ``(E, dff, d)`` and
    the shared experts.  ``dtype`` casts every weight but the router, which
    stays f32 (see ``layers.normal_init``)."""
    mc = cfg.moe
    d, dff = cfg.d_model, mc.d_ff_expert
    std_out = dff ** -0.5 / (2 * cfg.n_layers) ** 0.5
    p = {
        "router": L.linear_init(gen, d, mc.n_experts, device=device, std=0.02),
        "w_in": L.normal_init(gen, (mc.n_experts, d, dff), d ** -0.5, device,
                              dtype),
        "w_gate": L.normal_init(gen, (mc.n_experts, d, dff), d ** -0.5,
                                device, dtype),
        "w_out": L.normal_init(gen, (mc.n_experts, dff, d), std_out, device,
                               dtype),
    }
    if mc.n_shared:
        width = mc.n_shared * dff
        p["shared"] = {
            "w_in": L.linear_init(gen, d, width, device=device, dtype=dtype),
            "w_gate": L.linear_init(gen, d, width, device=device,
                                    dtype=dtype),
            "w_out": L.linear_init(gen, width, d, device=device, std=std_out,
                                   dtype=dtype),
        }
    return p


def _capacity(mc: MoEConfig, tokens_per_group: int) -> int:
    cap = int(tokens_per_group * mc.top_k * mc.capacity_factor / mc.n_experts)
    return max(cap, mc.top_k)


def route(params, x: torch.Tensor, cfg: ModelConfig):
    """The f32 router of ``x (B, S, d)``: logits and probabilities (B, S, E)
    and the top-k ``gate_vals`` (renormalised) and ``gate_idx`` (B, S, K),
    largest first, ties to the lower expert index as ``jax.lax.top_k``."""
    logits = L.linear_apply(params["router"], x.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    return logits, probs, gate_vals, gate_idx


def _routing_margin(logits, probs, k: int) -> torch.Tensor:
    """Each token's k-th largest router logit less its (k+1)-th, in the
    order ``route`` ranks them (inf where there is no (k+1)-th)."""
    if k >= logits.shape[-1]:
        return torch.full(logits.shape[:-1], float("inf"),
                          device=logits.device)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    pair = torch.gather(logits, -1, order[..., k - 1:k + 1])
    return pair[..., 0] - pair[..., 1]


def aux_losses(logits, probs, gate_idx, cfg: ModelConfig) -> Dict:
    """The load-balancing loss and the router z-loss."""
    mc = cfg.moe
    e = mc.n_experts
    me = torch.mean(probs, dim=(0, 1))                           # (E,)
    ce = torch.mean(torch.sum(F.one_hot(gate_idx, e).to(torch.float32),
                              dim=2), dim=(0, 1))                # (E,)
    return {"aux_loss": mc.aux_loss * e * torch.sum(me * ce),
            "z_loss": mc.router_z_loss * torch.mean(
                torch.square(torch.logsumexp(logits, dim=-1)))}


def queue_positions(gate_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, k) assignment's position in its expert's queue, counted
    over the group's flattened ``(S * K)`` assignments in token-major, then
    k order: (B, S, K) int64."""
    b, s, k = gate_idx.shape
    onehot = F.one_hot(gate_idx, n_experts)                      # (B,S,K,E)
    flat = onehot.reshape(b, s * k, n_experts)
    pos_flat = torch.cumsum(flat, dim=1) - flat
    return torch.sum(pos_flat.reshape(b, s, k, n_experts) * onehot, dim=-1)


def _combine_rows(ye, gate_idx, pos_c, w, e0: Optional[int] = None):
    """Sum over k of ``w[..., k] * ye[gate_idx, b, pos_c]`` in f32, in k
    order.  With ``e0``, ``ye (E_local, B, C, d)`` holds the experts
    ``[e0, e0 + E_local)`` only, and an assignment to another expert adds
    a zero term.  The gather's backward adds into a slot twice only where
    a dropped assignment (weight 0) was clamped onto a kept one's slot,
    and then adds an exact zero, so its sums do not depend on the order of
    the adds."""
    b_idx = torch.arange(gate_idx.shape[0], device=ye.device)
    if e0 is not None:
        local = gate_idx - e0
        inside = (local >= 0) & (local < ye.shape[0])
        gate_idx = torch.where(inside, local, 0)
        w = w * inside[..., None]
    terms = w * ye[gate_idx, b_idx[:, None, None], pos_c].to(torch.float32)
    acc = terms[:, :, 0]
    for j in range(1, terms.shape[2]):
        acc = acc + terms[:, :, j]
    return acc


def _combine(ye, gate_idx, pos_c, w):
    """The combine, (B, S, d): f32, or on a mesh in ``ye``'s dtype.  On a
    mesh each rank sums the terms of its own experts' rows in f32 (``ye``
    stays split over the experts, where a gather of each token's rows
    would need ``ye`` whole on every rank), casts them to ``ye``'s dtype
    and reduces them over the experts' mesh dims, as the reference's
    einsum reduces its partial products in the model dtype."""
    from torch.distributed.tensor import DTensor
    if not isinstance(ye, DTensor):
        return _combine_rows(ye, gate_idx, pos_c, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = ye.device_mesh
    coord = mesh.get_coordinate()
    e0, n = 0, 1
    tok = []                    # the tokens' layout: ye's batch split
    for i, p in enumerate(ye.placements):
        if p == Shard(0):
            e0, n = e0 * mesh.size(i) + coord[i], n * mesh.size(i)
        tok.append(Shard(0) if p == Shard(1) else Replicate())
    e_local = ye.shape[0] // n
    grad_w = [Partial() if p == Shard(0) else q
              for p, q in zip(ye.placements, tok)]
    ye_l = ye.to_local(grad_placements=ye.placements)
    idx_l, pos_l = (t.redistribute(mesh, tok).to_local()
                    for t in (gate_idx, pos_c))
    w_l = w.redistribute(mesh, tok).to_local(grad_placements=grad_w)
    acc = _combine_rows(ye_l, idx_l, pos_l, w_l, e0 * e_local).to(ye.dtype)
    part = [Partial() if p == Shard(0) else q
            for p, q in zip(ye.placements, tok)]
    with kept_for_backward():   # reduced once, not again in the recompute
        return DTensor.from_local(acc, mesh, part, run_check=False
                                  ).redistribute(mesh, tok)


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
              losses: bool = True, tokenwise: bool = False
              ) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, d) -> (out (B, S, d) in the compute dtype, aux), with aux
    ``{"aux_loss", "z_loss"}``; ``losses=False`` (the serve steps) leaves
    aux empty.  ``tokenwise`` runs the router and the shared experts one
    token at a time (``layers.per_token``).  Groups are the B sequences.
    While the recorder (``repro_torch/trace.py``) is on, each call's top-k
    expert ids and the margin of each token's k-th over its (k+1)-th router
    logit (inf with no (k+1)-th) are kept, on their device, as its
    routing."""
    mc = cfg.moe
    dt = cfg.compute_dtype
    b, s, d = x.shape
    e, k, cap = mc.n_experts, mc.top_k, _capacity(mc, s)

    def rowwise(fn):
        return L.per_token(fn, x) if tokenwise else fn(x)

    if tokenwise:       # int8 weights dequantized once, not per token
        params = dict(params, router=L.dequantized(params["router"]))
        if mc.n_shared:
            params["shared"] = L.dequantized(params["shared"], dt, rows=b)

    logits, probs, gate_vals, gate_idx = rowwise(
        functools.partial(route, params, cfg=cfg))
    aux = aux_losses(logits, probs, gate_idx, cfg) if losses else {}
    if trace.enabled():
        trace.routing(gate_idx, _routing_margin(logits, probs, k))

    # ---- capacity-limited dispatch ----------------------------------------
    pos = queue_positions(gate_idx, e)                           # (B,S,K)
    keep = pos < cap
    pos_c = torch.clamp_max(pos, cap - 1)  # a dropped one adds a 0 anywhere

    def scatter(slot, kept):
        d = torch.zeros(slot.shape[:2] + (e * cap,), dtype=dt,
                        device=slot.device)
        return d.scatter_(2, slot, kept)

    # on a mesh, each rank scatters its own rows (DTensor has no scatter_
    # strategy)
    slot = gate_idx * cap + pos_c
    dispatch = per_rank(scatter, slot, (slot, keep.to(dt)),
                        ({0: 0}, {0: 0}), {0: 0})
    dispatch = shard(dispatch.reshape(b, s, e, cap), "batch", None, "expert",
                     None)

    # ---- expert FFN (stacked batched GEMMs) --------------------------------
    xe = torch.einsum("bsec,bsd->ebcd", dispatch, x.to(dt))      # (E,B,C,d)
    xe = shard(xe, "expert", "batch", None, None)
    h = torch.einsum("ebcd,edf->ebcf", xe, params["w_in"].to(dt))
    g = torch.einsum("ebcd,edf->ebcf", xe, params["w_gate"].to(dt))
    ye = torch.einsum("ebcf,efd->ebcd", F.silu(g) * h,
                      params["w_out"].to(dt))                    # (E,B,C,d)
    ye = shard(ye, "expert", "batch", None, None)

    # ---- combine: gate-weighted rows, cast to dt, summed in f32 ------------
    w = (gate_vals * keep).to(dt).to(torch.float32)[..., None]
    acc = _combine(ye, gate_idx, pos_c, w)
    out = acc.to(dt)

    # ---- shared experts ------------------------------------------------------
    if mc.n_shared:
        out = out + rowwise(functools.partial(M.mlp_apply, params["shared"],
                                              cfg=cfg))
    return out, aux
