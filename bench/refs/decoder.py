"""Plain reference of a served decoder (dense SwiGLU or DeepSeekMoE), in
float32 PyTorch, for the benchmark's ``correct``.  It imports nothing of
the system under test and takes nothing the system made: it reads the
benchmark's weights (``weights.py``), the tokens that were served and,
for a model with routed experts, the expert ids that the program's router
chose at every position fed to it, and it checks both.  Everything the
system derived it works out again (the int8 KV pool's scales, the LUTs,
each attention's scales, the gates and the capacity drops).

What it computes is the configuration as stated in its file: a
Llama-style decoder (RMSNorm eps 1e-6, rotary positions over the two
halves of each head, SwiGLU), with DeepSeekMoE's layers where the file has
experts (an f32 softmax router, the top-k gates renormalised, a
sequence's prompt dropping the assignments past ``int(S * k * cf / E)``
in token-major then k order, the shared experts beside), served through
CIMple's int8 attention:

* with ``routes``, each MoE layer takes the program's expert ids in place
  of its own top-k: the gates are its own f32 softmax probabilities at
  those ids (renormalised where the file says), the prompt's drops follow
  from those ids by the same rule, and the routing is checked by itself:
  a position's route gap is the amount by which the reference's k-th
  largest router logit lies above its router logit of an expert the
  program chose (0 where the program chose the reference's own top-k),
  read by a router that reads the reference's own hidden state, which
  follows the program's routing upstream, and averaged over the positions
  of each MoE layer;

* a prompt position attends through the prefill datapath: q, k and v of
  the prompt int8 with one absmax scale each over all heads and
  positions;
* a generated position attends through the decode datapath: its query
  int8 with its own absmax scale, the keys and values int8 with the
  pool's static per-layer scales, which the first admitted prompt set
  (its absmax over all heads and positions);
* either way the int8 scores ``q_q . k_q`` are requantized to int8 by
  ``m_z = s_q s_k / (sqrt(D) s_z)`` (round half to even, clipped), the
  exponentials read from the 256-entry exp table
  ``round(exp((z - 127) s_z) 2^15)``, summed exactly with ``e . v_q``, and
  the sum's reciprocal read from the 256-entry table of its top mantissa
  bits: ``out = acc * M[i] * 2^-(e + 15) * s_v``.

Every float stage is float32 (TF32 off); the integer sums are exact (in
float64).  Logits come back only at the positions asked for.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6
Z_MAX = 127


def exp_table(scale_z: float, frac_bits: int, device) -> torch.Tensor:
    idx = np.arange(256, dtype=np.float64)
    vals = np.round(np.exp((idx - 128.0 - Z_MAX) * scale_z) * (1 << frac_bits))
    return torch.from_numpy(vals).to(device=device, dtype=torch.float64)


def recip_table(index_bits: int, frac_bits: int, device) -> torch.Tensor:
    i = np.arange(1 << index_bits, dtype=np.float64)
    vals = np.round((1 << frac_bits) / (1.0 + (i + 0.5) / (1 << index_bits)))
    return torch.from_numpy(vals).to(device=device, dtype=torch.float32)


class Numerics:
    """The attention datapath's constants, from the configuration file."""

    def __init__(self, serve: Dict, head_dim: int, device):
        self.scale_z = float(serve["scale_z"])
        self.ibits = int(serve["lut_recip_index_bits"])
        self.fbits = int(serve["lut_recip_frac_bits"])
        self.exp = exp_table(self.scale_z, int(serve["lut_exp_frac_bits"]),
                             device)
        self.recip = recip_table(self.ibits, self.fbits, device)
        self.denom = float(np.float32(math.sqrt(head_dim))
                           * np.float32(self.scale_z))

    def reciprocal(self, s: torch.Tensor) -> torch.Tensor:
        """The table's ``1 / s`` (f32 ``s >= 1``)."""
        s = torch.clamp_min(s, 1.0)
        mant, expo = torch.frexp(s)            # s = mant * 2^expo, mant in [.5, 1)
        frac = mant * 2.0 - 1.0                # s = (1 + frac) * 2^(expo - 1)
        idx = torch.floor(frac * (1 << self.ibits)).long()
        return self.recip[idx] * torch.exp2(-(expo - 1 + self.fbits).float())


def absmax_scale(x: torch.Tensor, dims=None) -> torch.Tensor:
    a = x.abs().amax() if dims is None else x.abs().amax(dim=dims, keepdim=True)
    return torch.clamp_min(a, 1e-8) / 127.0


def quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / s), -128, 127)


def split_softmax(q_q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                  m_z: torch.Tensor, s_v: torch.Tensor, visible: torch.Tensor,
                  nm: Numerics) -> torch.Tensor:
    """``q_q (Hkv, G, n, D)``, ``k_q``, ``v_q (Hkv, S, D)`` int-valued f32;
    ``m_z`` broadcasting to (.., n, 1); ``visible (n, S)`` -> (Hkv, G, n, D)."""
    z32 = q_q @ k_q[:, None].transpose(-1, -2)             # exact integers
    z_q = torch.clamp(torch.round(z32 * m_z), -128, 127)
    e = nm.exp[(z_q + 128).long()]
    e = torch.where(visible, e, 0.0)
    acc = (e @ v_q[:, None].double()).float()
    r = nm.reciprocal(e.sum(-1, keepdim=True).float())
    return acc * r * s_v


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D), positions 0..S-1."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = torch.arange(x.shape[0], dtype=torch.float32,
                       device=x.device)[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS) * scale


def dense(leaf: Dict, low=None) -> torch.Tensor:
    """A weight leaf as the f32 matrix it stands for (or, with ``low``, as
    ``low.weight`` rounds it)."""
    w = leaf["q"].float() * leaf["s"] if "q" in leaf else leaf["w"].float()
    return low.weight(w) if low is not None else w


def mm(x: torch.Tensor, w: torch.Tensor, low=None) -> torch.Tensor:
    """``x @ w``; with ``low``, its input first rounded by ``low.act``."""
    return (low.act(x) if low is not None else x) @ w


def attention(q, k, v, prompt_len: int, pool, nm: Numerics,
              row_budget: int = 1 << 26) -> torch.Tensor:
    """One sequence's attention, q (S, Hq, D), k, v (S, Hkv, D) -> (S, Hq*D):
    positions below ``prompt_len`` through the prefill datapath, the rest
    through the decode datapath over the pool (``pool = (s_k, s_v)``)."""
    s, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    out = torch.empty((s, hq, d), dtype=torch.float32, device=q.device)
    kpos = torch.arange(s, device=q.device)
    # the prompt: one scale per tensor
    p = prompt_len
    s_q, s_k, s_v = (absmax_scale(t[:p]) for t in (q, k, v))
    k_q = quantize(k[:p], s_k).transpose(0, 1)              # (Hkv, P, D)
    v_q = quantize(v[:p], s_v).transpose(0, 1)
    q_q = quantize(q[:p], s_q).reshape(p, hkv, g, d).permute(1, 2, 0, 3)
    m_z = s_q * s_k / nm.denom
    step = max(1, row_budget // (hq * p))
    for lo in range(0, p, step):
        hi = min(p, lo + step)
        vis = kpos[None, :p] <= kpos[lo:hi, None]
        o = split_softmax(q_q[:, :, lo:hi], k_q, v_q, m_z, s_v, vis, nm)
        out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, hq, d)
    if s > p:
        pk, pv = pool
        k_q = quantize(k, pk).transpose(0, 1)               # (Hkv, S, D)
        v_q = quantize(v, pv).transpose(0, 1)
        qd = q[p:]
        s_qt = absmax_scale(qd, dims=(1, 2))                # (n, 1, 1)
        q_q = quantize(qd, s_qt).reshape(s - p, hkv, g, d).permute(1, 2, 0, 3)
        m_z = (s_qt.reshape(-1, 1) * pk) / nm.denom         # (n, 1)
        step = max(1, row_budget // (hq * s))
        for lo in range(0, s - p, step):
            hi = min(s - p, lo + step)
            vis = kpos[None, :] <= kpos[p + lo:p + hi, None]
            o = split_softmax(q_q[:, :, lo:hi], k_q, v_q, m_z[lo:hi], pv,
                              vis, nm)
            out[p + lo:p + hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, hq, d)
    return out.reshape(s, hq * d)


def swiglu(x, w_in, w_gate, w_out, low=None):
    return mm(F.silu(mm(x, w_gate, low)) * mm(x, w_in, low), w_out, low)


def moe(h_all: List[torch.Tensor], prompt_lens: Sequence[int], m: Dict,
        c: Dict, serve: Dict, low=None, follow=None):
    """The MoE layer over every sequence at once; capacity per sequence's
    prompt.  ``follow`` (every sequence's rows, ``(sum S, k)``) replaces
    the top-k.  Returns the outputs, the ids taken and, with ``follow``,
    each row's route gap (zeros without)."""
    e_n, k = c["n_routed_experts"], c["num_experts_per_tok"]
    router = dense(m["router"], low)
    xs = torch.cat(h_all)
    logits = mm(xs, router, low)
    probs = torch.softmax(logits, dim=-1)
    if follow is None:
        idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
        gap = torch.zeros(xs.shape[0], device=xs.device)
    else:
        idx = follow
        kth = torch.topk(logits, k, dim=-1).values[:, -1]
        gap = kth - logits.gather(1, idx).amin(-1)
    gates = probs.gather(1, idx)
    if serve["moe_renormalize_top_k"]:
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    keep = torch.ones_like(gates, dtype=torch.bool)
    at = 0
    for h, p in zip(h_all, prompt_lens):
        cap = max(int(p * k * serve["moe_capacity_factor"] / e_n), k)
        onehot = F.one_hot(idx[at:at + p], e_n).reshape(p * k, e_n)
        pos = (torch.cumsum(onehot, 0) - onehot)[
            torch.arange(p * k, device=idx.device), idx[at:at + p].reshape(-1)]
        keep[at:at + p] = (pos < cap).reshape(p, k)
        at += h.shape[0]
    out = torch.zeros_like(xs)
    w = gates * keep
    for e in range(e_n):
        rows, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        w_in, w_gate, w_out = (dense({"w": m[n]["w"][e]}, low)
                               for n in ("w_in", "w_gate", "w_out"))
        y = swiglu(xs[rows], w_in, w_gate, w_out, low)
        out.index_add_(0, rows, y * w[rows, slot][:, None])
    if "shared" in m:
        sh = m["shared"]
        out = out + swiglu(xs, *(dense(sh[n], low)
                                 for n in ("w_in", "w_gate", "w_out")), low)
    return list(torch.split(out, [h.shape[0] for h in h_all])), idx, gap


@torch.no_grad()
def logits_at(W: Dict, conf: Dict, seqs: Sequence[np.ndarray],
              prompt_lens: Sequence[int], calib: int,
              at: Sequence[Sequence[int]], low=None,
              routes: Optional[Sequence[Dict[int, torch.Tensor]]] = None
              ) -> Dict:
    """f32 logits (len(at[i]), vocab) of each sequence ``seqs[i]`` at the
    positions ``at[i]``.  ``seqs[calib]``'s prompt is the one that set the
    pool's scales.  ``low`` (the control) rounds every weight matrix
    (``low.weight``) and every matrix product's input (``low.act``) to a
    lower precision.  ``routes[i][layer]``, the ``(len(seqs[i]), k)``
    expert ids at every position of ``seqs[i]`` in each MoE layer (the
    index of ``W["layers"]``), replaces the reference's own top-k.

    Returns ``logits`` (that list), ``routes`` (the ids each MoE layer
    took, in ``routes``' form) and ``route_gap_layers``, each MoE layer's
    mean route gap over every sequence and position (0 without
    ``routes``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c, serve = conf["config"], conf["serve"]
    dev = W["norm"].device
    d, hq, hkv = (c["hidden_size"], c["num_attention_heads"],
                  c["num_key_value_heads"])
    hd = d // hq
    nm = Numerics(serve, hd, dev)
    norm = W["norm"].float()
    ids = [torch.as_tensor(t, device=dev) for t in seqs]
    if low is None and "q" in W["embed"]:
        xs = [W["embed"]["q"][i].float() * W["embed"]["s"] for i in ids]
    else:
        emb = dense(W["embed"], low)
        xs = [emb[i] for i in ids]
        del emb
    taken: List[Dict[int, torch.Tensor]] = [{} for _ in seqs]
    gaps: List[torch.Tensor] = []
    for li, lw in enumerate(W["layers"]):
        wq, wk, wv = (dense(lw[n], low) for n in ("wq", "wk", "wv"))
        qkv = []
        for x in xs:
            h = rms(x, norm)
            qkv.append((rope(mm(h, wq, low).reshape(-1, hq, hd), c["rope_theta"]),
                        rope(mm(h, wk, low).reshape(-1, hkv, hd), c["rope_theta"]),
                        mm(h, wv, low).reshape(-1, hkv, hd)))
        del wq, wk, wv
        pc = prompt_lens[calib]
        pool = (absmax_scale(qkv[calib][1][:pc]), absmax_scale(qkv[calib][2][:pc]))
        wo = dense(lw["wo"], low)
        xs = [x + mm(attention(q, k, v, p, pool, nm), wo, low)
              for x, (q, k, v), p in zip(xs, qkv, prompt_lens)]
        del qkv, wo
        hs = [rms(x, norm) for x in xs]
        if "moe" in lw:
            follow = None
            if routes is not None:
                if any(r[li].shape[0] != len(t) for r, t in zip(routes, seqs)):
                    raise ValueError(f"layer {li}: routes of another length "
                                     f"than their sequences")
                follow = torch.cat([r[li] for r in routes])
            ys, idx, g = moe(hs, prompt_lens, lw["moe"], c, serve, low, follow)
            gaps.append(g)
            for t, ids in zip(taken, torch.split(idx, [len(x) for x in seqs])):
                t[li] = ids
        else:
            mats = [dense(lw[n], low) for n in ("w_in", "w_gate", "w_out")]
            ys = [swiglu(h, *mats, low) for h in hs]
            del mats
        xs = [x + y for x, y in zip(xs, ys)]
        del hs, ys
    head = dense(W["head"], low)
    out = [mm(rms(x[torch.as_tensor(list(pos), dtype=torch.long, device=dev)],
                  norm), head, low)
           for x, pos in zip(xs, at)]
    return {"logits": out, "routes": taken,
            "route_gap_layers": [float(g.mean()) for g in gaps] or [0.0]}
