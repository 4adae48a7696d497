"""Selective state-space blocks: Mamba-1 (Falcon-Mamba) and Mamba-2 (Zamba2)
(port of ``repro/models/ssm.py``).

There is no softmax in these blocks, so no kernel either: the reference's
scans are XLA, and here they are plain PyTorch in the reference's order of
operations.  The projections run in the compute dtype, the recurrences in
f32.

Full-sequence scans are chunked: a loop over chunks carries the recurrent
state, and within a chunk the recurrence is solved in parallel.  Mamba-1
uses :func:`_associative_scan`, JAX's odd/even recursion of
``jax.lax.associative_scan`` written out, so the f32 products and sums are
combined in the reference's order; Mamba-2 uses the matmul ("state-space
duality") form.  A sequence that no chunk divides is padded with identity
steps in its last chunk, as the reference pads it.  Decode carries ``{"conv":
(B, d_conv-1, C), "h": ...}`` per layer, O(1) in the sequence length.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import current_axis_rules, per_rank, shard
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   tail: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, S, C); w: (K, C); tail: (B, K-1, C),
    the carried inputs (None: zeros).  Returns (y, new_tail); the tail is
    a copy, not a view that would keep the padded input alive."""
    k = w.shape[0]
    b, s, c = x.shape
    if tail is None:
        tail = torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)                  # (B, S+K-1, C)
    y = torch.zeros_like(x)
    for i in range(k):                                # K taps, unrolled
        y = y + xp[:, i:i + s] * w[i]
    return y, xp[:, -(k - 1):].clone()


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < t <= i} log_a[..., t] (the decay from
    step j+1 to i), -inf above the diagonal."""
    t = log_a.shape[-1]
    x = torch.cumsum(log_a, dim=-1)
    diff = x[..., :, None] - x[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, -math.inf)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as max(x, 0) + log1p(e^-|x|)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _uniform_log_dt(gen, shape, device) -> torch.Tensor:
    """The reference's dt initializer: exp of a uniform draw in
    [log 1e-3, log 1e-1], through the inverse softplus."""
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo
    return torch.log(torch.expm1(torch.exp(u)))


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba-7b)
# ---------------------------------------------------------------------------

def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or max(cfg.d_model // 16, 1)


def mamba1_init(gen, cfg: ModelConfig, *, device,
                dtype: torch.dtype = torch.float32) -> L.Params:
    """The reference's leaves and scales.  ``dtype`` applies to the leaves
    a serve step casts (the projections and ``conv_w``); ``dt_proj``,
    ``A_log`` and ``D`` stay f32."""
    sc = cfg.ssm
    d, di, n = cfg.d_model, cfg.d_inner, sc.d_state
    r = _dt_rank(cfg)
    return {
        "in_proj": L.linear_init(gen, d, 2 * di, device=device, dtype=dtype),
        "conv_w": L.normal_init(gen, (sc.d_conv, di), di ** -0.5, device,
                                dtype),
        "x_proj": L.linear_init(gen, di, r + 2 * n, device=device,
                                dtype=dtype),
        "dt_proj": {"w": L.normal_init(gen, (r, di), r ** -0.5, device),
                    "b": _uniform_log_dt(gen, (di,), device)},
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=device)).expand(di, n).clone(),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": L.linear_init(gen, di, d, device=device, dtype=dtype,
                                  std=di ** -0.5 / (2 * cfg.n_layers) ** 0.5),
    }


def _combine(left, right, out=None):
    """The linear recurrence's operator, (a_l, b_l) then (a_r, b_r) ->
    (a_l a_r, a_r b_l + b_r), written into ``out`` when given (each
    product rounded, then the sum: no fused multiply-add)."""
    (al, bl), (ar, br) = left, right
    if out is None:
        return al * ar, ar * bl + br
    torch.mul(al, ar, out=out[0])
    torch.mul(ar, bl, out=out[1]).add_(br)
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the pairs (a_t, b_t) along dim 1 under
    :func:`_combine`, by ``jax.lax.associative_scan``'s recursion: combine
    adjacent pairs, scan those (the odd outputs), then combine each odd
    output with the next even input, interleaved.  log2(n) levels of a few
    elementwise launches each; the even outputs are written in place into
    the interleaved result."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _associative_scan(*_combine(
        (a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2])))
    m = odd_a.shape[1] - (1 - n % 2)       # n even: all but the last
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0], out_b[:, 0] = a[:, 0], b[:, 0]
    out_a[:, 1::2], out_b[:, 1::2] = odd_a, odd_b
    pairs = ((odd_a[:, :m], odd_b[:, :m]), (a[:, 2::2], b[:, 2::2]))
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        # autograd records no out= product: the same ops, then a copy
        out_a[:, 2::2], out_b[:, 2::2] = _combine(*pairs)
    else:
        _combine(*pairs, out=(out_a[:, 2::2], out_b[:, 2::2]))
    return out_a, out_b


def _mamba1_scan_chunked(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor,
                         chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + bx_t, chunk-parallel.  a, bx: (B, S, D, N);
    h0: (B, D, N).  Returns (h_all (B, S, D, N), h_last); ``h_last`` is a
    copy, not a view that would keep a chunk's (B, chunk, D, N) scan
    alive (64 of them in a serve-mode forward)."""
    b, s, d, n = a.shape
    chunk = min(chunk, s)
    h = h0
    h_all = torch.empty_like(a)                       # (B, S, D, N) f32
    for c0 in range(0, s, chunk):
        ac, bc = a[:, c0:c0 + chunk], bx[:, c0:c0 + chunk]
        m = ac.shape[1]
        if m < chunk:
            # identity steps (a = 1, b = 0): the state is kept past s
            pad = (b, chunk - m, d, n)
            ac = torch.cat([ac, torch.ones(pad, dtype=ac.dtype,
                                           device=ac.device)], dim=1)
            bc = torch.cat([bc, torch.zeros(pad, dtype=bc.dtype,
                                            device=bc.device)], dim=1)
        aa, bb = _associative_scan(ac, bc)
        # aa * h + bb: its first m rows straight into h_all, and its last
        # (padded) row, the carry, on its own
        if torch.is_grad_enabled() and aa.requires_grad:
            h_all[:, c0:c0 + m] = aa[:, :m] * h[:, None] + bb[:, :m]
        else:
            torch.mul(aa[:, :m], h[:, None], out=h_all[:, c0:c0 + m]).add_(
                bb[:, :m])
        h = aa[:, -1] * h + bb[:, -1]
    return h_all, h


def mamba1_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                 state: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, d_model) -> (y, new_state).  ``state`` carries {"conv":
    (B, K-1, di), "h": (B, di, N)} (decode, and the serve-mode prefill from
    zeros); None in training.  The (B, S, di, N) f32 discretization is
    freed once the scan has run."""
    sc = cfg.ssm
    dt = cfg.compute_dtype
    n = sc.d_state
    r = _dt_rank(cfg)
    xs, z = L.split_linear_apply(params["in_proj"], x,
                                 [cfg.d_inner] * 2, dtype=dt)  # (B, S, di)
    xs = shard(xs, "batch", None, "mlp")
    conv_tail = state["conv"] if state is not None else None
    xs, new_tail = _causal_conv1d(xs, params["conv_w"].to(dt), conv_tail)
    xs = F.silu(xs)

    proj = L.linear_apply(params["x_proj"], xs, dtype=dt).to(torch.float32)
    # its partial sums over the inner dim reduced whole: left partial,
    # DTensor reduce-scatters them over the sequence, and every chunk of
    # the scan then gathers the sequence back
    proj = shard(proj, "batch", None, None)
    dt_in, bmat, cmat = torch.split(proj, [r, n, n], dim=-1)
    delta = _softplus(dt_in @ params["dt_proj"]["w"]
                      + params["dt_proj"]["b"])           # (B, S, di)
    a_mat = -torch.exp(params["A_log"])                   # (di, N)
    xf = xs.to(torch.float32)
    da = torch.exp(delta[..., None] * a_mat)              # (B, S, di, N)
    dbx = (delta * xf)[..., None] * bmat[:, :, None, :]
    h0 = (state["h"] if state is not None else
          torch.zeros((x.shape[0], cfg.d_inner, n), dtype=torch.float32,
                      device=x.device))
    # on a mesh, each rank scans its own rows and channels
    h_all, h_last = per_rank(
        lambda a, bx, h: _mamba1_scan_chunked(a, bx, h, sc.chunk), da,
        (da, dbx, h0), ({0: 0, 2: 2}, {0: 0, 2: 2}, {0: 0, 2: 1}),
        ({0: 0, 2: 2}, {0: 0, 2: 1}))
    del da, dbx
    y = torch.einsum("bsdn,bsn->bsd", h_all, cmat)        # (B, S, di)
    del h_all
    y = y + xf * params["D"]
    y = (y * F.silu(z.to(torch.float32))).to(dt)
    out = L.linear_apply(params["out_proj"], y, dtype=dt)
    new_state = ({"conv": new_tail, "h": h_last} if state is not None
                 else None)
    return out, new_state


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2)
# ---------------------------------------------------------------------------

def mamba2_init(gen, cfg: ModelConfig, *, device,
                dtype: torch.dtype = torch.float32) -> L.Params:
    """The reference's leaves and scales; ``dtype`` as in
    :func:`mamba1_init` (``A_log``, ``D``, ``dt_bias`` and the norm stay
    f32)."""
    sc = cfg.ssm
    d, di, n, p = cfg.d_model, cfg.d_inner, sc.d_state, sc.headdim
    nh = di // p
    return {
        # fused projection: [z (di), x (di), B (n), C (n), dt (nh)]
        "in_proj": L.linear_init(gen, d, 2 * di + 2 * n + nh, device=device,
                                 dtype=dtype),
        "conv_w": L.normal_init(gen, (sc.d_conv, di + 2 * n),
                                (di + 2 * n) ** -0.5, device, dtype),
        "A_log": torch.log(torch.rand((nh,), generator=gen, device=device)
                           * 15.0 + 1.0),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": _uniform_log_dt(gen, (nh,), device),
        "norm": L.rmsnorm_init(di, device),
        "out_proj": L.linear_init(gen, di, d, device=device, dtype=dtype,
                                  std=di ** -0.5 / (2 * cfg.n_layers) ** 0.5),
    }


def _ssd_chunk(hprev, xck, lck, bck, cck):
    """One chunk of the SSD: xck (B, c, H, P), lck (B, c, H), bck/cck (B,
    c, N), hprev (B, H, N, P) -> (y (B, c, H, P), h_new)."""
    # intra-chunk ("diagonal") term: attention-like, under the decay mask
    decay_mat = torch.exp(_segsum(lck.transpose(1, 2)))   # (B, H, c, c)
    scores = cck @ bck.transpose(1, 2)                    # (B, c, c)
    xh = xck.permute(0, 2, 1, 3)                          # (B, H, c, P)
    y_diag = (scores[:, None] * decay_mat) @ xh           # (B, H, c, P)
    # inter-chunk: the carried state's contribution
    decay_in = torch.exp(torch.cumsum(lck, dim=1))        # (B, c, H)
    y_off = ((cck[:, None] @ hprev)
             * decay_in.transpose(1, 2)[..., None])       # (B, H, c, P)
    # state: h_new = decay_total * h + sum_t decay_{t->end} B_t x_t
    total = decay_in[:, -1]                               # (B, H)
    decay_out = torch.exp(torch.flip(torch.cumsum(torch.flip(lck, [1]), 1),
                                     [1]) - lck)          # (B, c, H)
    xd = xh * decay_out.transpose(1, 2)[..., None]        # (B, H, c, P)
    h_new = (total[:, :, None, None] * hprev
             + bck.transpose(1, 2)[:, None] @ xd)         # (B, H, N, P)
    return (y_diag + y_off).permute(0, 2, 1, 3), h_new


def _ssd_chunked(xh: torch.Tensor, log_a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, h0: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2's SSD in matmul form, chunk by chunk.

    xh (B, S, H, P): head inputs (already scaled by dt); log_a (B, S, H):
    per-step log decay (dt * A, <= 0); bmat, cmat (B, S, N): shared across
    heads; h0 (B, H, N, P).  Returns (y (B, S, H, P), h_last)."""
    b, s, h, p = xh.shape
    chunk = min(chunk, s)
    y = torch.empty_like(xh, dtype=torch.float32)
    state = h0
    for c0 in range(0, s, chunk):
        parts = [t[:, c0:c0 + chunk] for t in (xh, log_a, bmat, cmat)]
        m = parts[0].shape[1]
        if m < chunk:
            # identity steps (decay 1, zero input): the state is frozen
            parts = [torch.cat([t, t.new_zeros((b, chunk - m)
                                               + tuple(t.shape[2:]))], 1)
                     for t in parts]
        yc, state = _ssd_chunk(state, *parts)
        y[:, c0:c0 + m] = yc[:, :m]
    return y, state


def _mamba2_in_on_mesh(params, x: torch.Tensor,
                       conv_tail: Optional[torch.Tensor], sizes, nh: int,
                       dt_: torch.dtype):
    """Mamba-2's input projection and convolution on a mesh: ``(z, x, B,
    C, dt, conv tail)``.  x, B and C are projected and convolved apart (the
    conv is depthwise, so the values are the unsplit path's), each in its
    own layout: their concatenation, split at other boundaries than its
    shards', would be gathered whole."""
    z, xs, bmat, cmat, dt_in = L.split_linear_apply(
        params["in_proj"], x, [sizes[0], *sizes, nh], dtype=dt_)
    tails = (torch.split(conv_tail, sizes, dim=-1) if conv_tail is not None
             else (None,) * 3)
    conv = [_causal_conv1d(part, w.to(dt_), tail) for part, w, tail in zip(
        (xs, bmat, cmat), torch.split(params["conv_w"], sizes, dim=-1),
        tails)]
    xs, bmat, cmat = (F.silu(y) for y, _ in conv)
    return z, xs, bmat, cmat, dt_in, torch.cat([t for _, t in conv], dim=-1)


def mamba2_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                 state: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The Mamba-2 block.  ``state``: {"conv": (B, K-1, di+2n), "h": (B, H,
    N, P)}, or None in training."""
    sc = cfg.ssm
    dt_ = cfg.compute_dtype
    di, n, p = cfg.d_inner, sc.d_state, sc.headdim
    nh = di // p
    b, s, _ = x.shape

    conv_tail = state["conv"] if state is not None else None
    if current_axis_rules() is None:
        zxbcdt = L.linear_apply(params["in_proj"], x, dtype=dt_)
        z, xbc, dt_in = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
        xbc, new_tail = _causal_conv1d(xbc, params["conv_w"].to(dt_),
                                       conv_tail)
        xbc = F.silu(xbc)
        xs, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    else:
        z, xs, bmat, cmat, dt_in, new_tail = _mamba2_in_on_mesh(
            params, x, conv_tail, [di, n, n], nh, dt_)
    xs = shard(xs, "batch", None, "mlp")

    delta = _softplus(dt_in.to(torch.float32)
                      + params["dt_bias"])                # (B, S, H)
    a = -torch.exp(params["A_log"])                       # (H,)
    log_a = delta * a                                     # (B, S, H) <= 0
    xf = xs.to(torch.float32).reshape(b, s, nh, p)
    h0 = (state["h"] if state is not None else
          torch.zeros((b, nh, n, p), dtype=torch.float32, device=x.device))
    xh = xf * delta[..., None]
    # on a mesh, each rank runs the SSD on its own rows and heads
    heads = {0: 0, 2: 2}
    y, h_last = per_rank(
        lambda *a: _ssd_chunked(*a, sc.chunk), xh,
        (xh, log_a, bmat.to(torch.float32), cmat.to(torch.float32), h0),
        (heads, heads, {0: 0}, {0: 0}, {0: 0, 2: 1}),
        (heads, {0: 0, 2: 1}))
    y = y + xf * params["D"][:, None]
    y = L.rmsnorm_apply(params["norm"], y.reshape(b, s, di))
    y = (y * F.silu(z.to(torch.float32))).to(dt_)
    out = L.linear_apply(params["out_proj"], y, dtype=dt_)
    new_state = ({"conv": new_tail, "h": h_last} if state is not None
                 else None)
    return out, new_state


MAMBA_INIT = {"mamba1": mamba1_init, "mamba2": mamba2_init}
MAMBA_APPLY = {"mamba1": mamba1_apply, "mamba2": mamba2_apply}


def state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, tuple]:
    """One layer's decode state: {"conv": (B, K-1, C), "h": (B, di, N)
    (Mamba-1) or (B, H, N, P) (Mamba-2)}."""
    sc = cfg.ssm
    if sc.kind == "mamba1":
        return {"conv": (batch, sc.d_conv - 1, cfg.d_inner),
                "h": (batch, cfg.d_inner, sc.d_state)}
    return {"conv": (batch, sc.d_conv - 1, cfg.d_inner + 2 * sc.d_state),
            "h": (batch, cfg.d_inner // sc.headdim, sc.d_state, sc.headdim)}


def zero_state(cfg: ModelConfig, batch: int, *, device) -> Dict:
    """One layer's zero state (the reference's ``_zero_ssm_state``): the
    conv tail in the compute dtype, ``h`` in f32."""
    shapes = state_shapes(cfg, batch)
    return {"conv": torch.zeros(shapes["conv"], dtype=cfg.compute_dtype,
                                device=device),
            "h": torch.zeros(shapes["h"], dtype=torch.float32, device=device)}


def init_ssm_state(cfg: ModelConfig, batch: int, n_layers: int, *, device
                   ) -> Dict[str, torch.Tensor]:
    """The stacked decode state of ``n_layers`` SSM layers: each leaf of
    :func:`zero_state` with a leading layer axis."""
    return {k: v.expand((n_layers,) + v.shape).clone()
            for k, v in zero_state(cfg, batch, device=device).items()}
