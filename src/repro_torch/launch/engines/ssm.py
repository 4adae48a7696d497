"""SSM cache engine: fixed-size per-slot int8 state slabs (port of
``repro/launch/engines/ssm.py``).

A Mamba layer's decode footprint is O(1) a sequence, a conv tail and the
recurrent state ``h``, so there is no block growth, no paging and no
over-commit: ``alloc`` stays None and the scheduler's pool machinery is
inert.  Between steps both live quantized, with a dynamic f32 scale per
(layer, slot), in one flat dict:

    conv_q int8 (L, S, d_conv-1, C)   conv_s f32 (L, S, 1, 1)
    h_q    int8 (L, S, ...)           h_s    f32 (L, S, 1, ...)
    length int32 (S,)

Each decode step dequantizes the whole slab, runs the float recurrence
(``models.transformer.decode_step`` -> ``models.ssm``) and requantizes it
in place.  ``absmax_scale`` puts each slab's largest magnitude at exactly
127, so requantizing a freshly dequantized slab gives back its scale and
its int8 values: an idle or retired slot that keeps stepping does not
drift.  Scales are per (layer, slot) and the recurrence is per row, so a
request's tokens do not depend on its slot or its co-residents, and a
preempted request resumes bit for bit through an ordinary admission and
the replay of its prefix.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import quantization as qlib
from repro_torch.launch.engines import base
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

STATES = ("conv", "h")


def quant_state(states: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{"conv", "h"} float (L, S, ...) -> int8 slabs ``<name>_q`` and their
    per-(L, S) scales ``<name>_s``."""
    out = {}
    for name in STATES:
        x = states[name]
        s = qlib.absmax_scale(x, axis=tuple(range(2, x.dim())))
        out[name + "_q"] = qlib.quantize(x, s)
        out[name + "_s"] = s
    return out


def dequant_state(slabs: Dict[str, torch.Tensor], cfg
                  ) -> Dict[str, torch.Tensor]:
    """The float state: the conv tail in the compute dtype, ``h`` in f32
    (the recurrence's)."""
    return {"conv": qlib.dequantize(slabs["conv_q"], slabs["conv_s"]).to(
                cfg.compute_dtype),
            "h": qlib.dequantize(slabs["h_q"], slabs["h_s"])}


class SSMStateEngine(base.CacheEngine):
    pool_tag = "ssm"
    warmup_prefills = 1
    warmup_decodes = 1

    def __init__(self, params, cfg, prompts: List[np.ndarray], *,
                 slots: int, max_len: int, block_k: int = 32,
                 pool_blocks: Optional[int] = None):
        if cfg.family != "ssm":
            raise ValueError(f"the SSM engine serves the ssm family, not "
                             f"{cfg.family!r}")
        if pool_blocks is not None:
            raise ValueError("--pool-blocks needs the paged KV cache "
                             f"(family {cfg.family} has none)")
        del max_len, block_k                # fixed footprint: no paging
        self.params = T.cast_for_serving(params, cfg)
        self.device = L.param_device(params)
        self.cfg = cfg
        self.prompts = prompts
        self.slots = slots
        self._state_bytes = cfg.n_layers * sum(       # int8-resident
            math.prod(shape) for shape in S.state_shapes(cfg, slots).values())

    def make_cache(self) -> Dict[str, torch.Tensor]:
        nl, dev = self.cfg.n_layers, self.device
        cache = {}
        for name, shape in S.state_shapes(self.cfg, self.slots).items():
            cache[name + "_q"] = torch.zeros((nl,) + shape, dtype=torch.int8,
                                             device=dev)
            cache[name + "_s"] = torch.full(
                (nl, self.slots) + (1,) * (len(shape) - 1), 1e-2,
                dtype=torch.float32, device=dev)
        cache["length"] = torch.zeros((self.slots,), dtype=torch.int32,
                                      device=dev)
        return cache

    def start_run(self):
        return self.make_cache()

    def _prefill(self, cache, slot: int, prompt: np.ndarray):
        """The prompt's forward from a zero state; its final state
        quantized into the slot's slabs."""
        tokens = torch.as_tensor(prompt, dtype=torch.int64,
                                 device=self.device)[None]
        logits, aux = T.forward(self.params, tokens, self.cfg, serve=True)
        for k, v in quant_state(aux["ssm"]).items():
            cache[k][:, slot] = v[:, 0]
        cache["length"][slot] = tokens.shape[1]
        return logits[:, -1], cache

    def warmup(self):
        """One throwaway prefill, decode step and release on a scratch
        cache, before the clock starts."""
        cache = self.make_cache()
        last1, cache = self._prefill(cache, 0, self.prompts[0])
        tokens = torch.zeros((self.slots,), dtype=torch.int64,
                             device=self.device)
        out, cache = self.decode(tokens, cache)
        self.release(cache, 0)
        out.cpu()
        return last1, out

    def admit(self, cache, slot: int, rid: int):
        return self._prefill(cache, slot, self.prompts[rid])

    def decode(self, tokens, cache):
        state = dict(dequant_state(cache, self.cfg), length=cache["length"])
        logits, state = T.decode_step(self.params, tokens, self.cfg, state)
        for k, v in quant_state(state).items():
            cache[k].copy_(v)
        return logits, cache

    def release(self, cache, slot: int):
        """Zero the slot's slabs and scales, as the reference does (an idle
        slot's state dequantizes to zeros)."""
        for name in STATES:
            cache[name + "_q"][:, slot] = 0
            cache[name + "_s"][:, slot] = 0
        cache["length"][slot] = 0
        return cache

    def kv_bytes_per_step(self, gens) -> int:
        """The whole int8 state is read and rewritten every step, whatever
        the sequence lengths."""
        return self._state_bytes
