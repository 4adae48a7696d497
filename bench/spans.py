"""Spans the harness records around the scheduler's calls into the engine,
and the measured window, which they also keep.

:class:`SpanEngine` stands in for the engine in
``launch/scheduler.py::run_schedule`` and delegates every call.  Each
call's entry and return are stamped on the host clock.  The tokens of an
admission or a decode reach the host inside the scheduler, right after
the call returns (it reads them to the host before it calls the engine
again), so they are stamped with the entry time of the next call.

The window opens at the first decode, once every client's first request
is admitted, and closes ``seconds`` later: the first call after that
raises :class:`WindowClosed` before it reaches the engine, and
``run_schedule`` unwinds.  The scheduler is a closed loop here: each slot
is a client, whose next request is sent when its previous request's last
token reached the host.

Served tokens are read back from the program's own outputs: a request's
tokens but its last are the ones the scheduler feeds to the decodes that
follow (the ``tokens`` tensors, kept by reference), and its last is the
greedy choice of its final decode's logits row.

With ``routes`` (a configuration with routed experts), the program's own
routing is kept beside them: :meth:`SpanEngine.start_run`, after the
warm-up and before the first admission, switches the port's recorder
(``repro_torch/trace.py``) on, and each admission and decode drains it and
keeps that call's top-k expert ids of every MoE layer, stacked on the
device into one ``(layers, B, S, k)`` tensor (one device op a call, no
host copy, no sync; the stack lets the sorted ``(B, S, E)`` tensors that
the recorded views hold go).  The stacks are slices of an arena of
``ROUTE_ARENA`` ids that :meth:`SpanEngine.start_run` reserves, so that
the ids the window keeps take no memory from the device's allocator in
the window: a request there that the cache cannot serve calls
``cudaMalloc``, which stalls the host.  A window that fills the arena
reserves another.  :meth:`SpanEngine.stop_routes`, which the caller
calls as the window closes, switches it off.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import trace

# ids an arena of kept routing holds: 2 GiB of int64, ~2.9 times what the
# code cell's 51 s window keeps
ROUTE_ARENA = 1 << 28


class WindowClosed(Exception):
    pass


class TrafficDrained(RuntimeError):
    pass


class SpanEngine:
    """A delegating wrapper of a cache engine that records spans."""

    def __init__(self, engine, gens: List[int], seconds: float, *,
                 clock: Callable[[], float] = time.perf_counter,
                 on_decode: Optional[Callable] = None,
                 routes: bool = False):
        self._engine = engine
        self._gens = gens
        self._seconds = seconds
        self._clock = clock
        self._on_decode = on_decode
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.calls: List[tuple] = []       # (kind, entry, return, arrival)
        self._pending: Optional[int] = None   # call awaiting its arrival
        self._need_rid: Optional[int] = None
        self.slot_rid: Dict[int, int] = {}
        self.produced: Dict[int, int] = {}     # rid -> tokens so far
        self.arrivals: Dict[int, List[float]] = {}
        self.sent: Dict[int, Optional[float]] = {}
        self.admit_calls: Dict[int, int] = {}  # rid -> index in calls
        self.free_at: Dict[int, float] = {}    # slot -> last token's arrival
        self.decodes: List[tuple] = []         # (tokens, [(slot, rid, j)])
        self.finals: Dict[int, torch.Tensor] = {}
        self.finished: Dict[int, int] = {}    # rid -> tokens served
        self.early_releases = 0    # preempted, or retired before its end
        self.admission_stalls = 0
        self._last_logits = None
        self._admit_rid: Optional[int] = None
        self._decode_rows: List[tuple] = []
        self._routes = routes
        self.route_layers: Optional[List[int]] = None
        self.admit_routes: Dict[int, torch.Tensor] = {}  # rid -> (L, S, k)
        self.decode_routes: List[torch.Tensor] = []      # (L, B, k) a decode
        self._arena: Optional[torch.Tensor] = None
        self._arena_used = 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    # -- bookkeeping ---------------------------------------------------------
    def _enter(self, kind: str) -> float:
        now = self._clock()
        if self._pending is not None:
            self._arrive(now)
        if self._need_rid is not None and kind != "admit":
            self.admission_stalls += self.t_open is not None
            self._need_rid = None
        if self.t_open is not None and now >= self.t_close:
            raise WindowClosed()
        return now

    def _arrive(self, now: float) -> None:
        i = self._pending
        self._pending = None
        kind, t_in, t_out, _ = self.calls[i]
        self.calls[i] = (kind, t_in, t_out, now)
        rows = ([self._admit_rid] if kind == "admit"
                else [rid for _, rid, _ in self._decode_rows])
        for rid in rows:
            self.produced[rid] += 1
            self.arrivals[rid].append(now)

    def _call(self, kind: str, t_in: float, fn, *args):
        out = fn(*args)
        self.calls.append((kind, t_in, self._clock(), None))
        return out

    def _drain_routes(self) -> torch.Tensor:
        """The top-k ids that the call just made recorded, one entry an MoE
        layer, as one ``(L, B, S, k)`` tensor."""
        got = trace.drain()["routes"]
        layers = [r["layer"] for r in got]
        if self.route_layers is None:
            self.route_layers = layers
        if not layers or layers != self.route_layers:
            raise RuntimeError(f"a call recorded the routing of the layers "
                               f"{layers}, not {self.route_layers}")
        ids = [r["idx"] for r in got]
        n = len(ids) * ids[0].numel()
        if self._arena_used + n > self._arena.numel():
            self._reserve(max(ROUTE_ARENA, n))
        out = self._arena[self._arena_used:self._arena_used + n]
        self._arena_used += n
        return torch.stack(ids, out=out.view(len(ids), *ids[0].shape))

    def _reserve(self, n: int) -> None:
        self._arena = torch.empty(n, dtype=torch.int64,
                                  device=self._engine.device)
        self._arena_used = 0

    # -- the engine protocol -------------------------------------------------
    def start_run(self):
        out = self._call("start_run", self._enter("start_run"),
                         self._engine.start_run)
        if self._routes:
            self._reserve(ROUTE_ARENA)
            trace.enable()
            trace.drain()
        return out

    def warmup(self):
        return self._call("warmup", self._enter("warmup"), self._engine.warmup)

    def stop_routes(self) -> None:
        if self._routes:
            trace.disable()

    def admission_need(self, rid):
        t = self._enter("admission_need")
        out = self._call("admission_need", t, self._engine.admission_need, rid)
        self._need_rid = rid
        return out

    def admit(self, cache, slot, rid):
        t = self._enter("admit")
        self._need_rid = None
        if rid == len(self._gens) - 1:
            raise TrafficDrained(
                f"request {rid} is the traffic's last: the request list is "
                f"too short for the window")
        self.slot_rid[slot] = rid
        self.produced[rid] = 0
        self.arrivals[rid] = []
        self.sent[rid] = self.free_at.get(slot)
        self._admit_rid = rid
        out = self._call("admit", t, self._engine.admit, cache, slot, rid)
        if self._routes:
            self.admit_routes[rid] = self._drain_routes()[:, 0]
        self.admit_calls[rid] = len(self.calls) - 1
        self._pending = len(self.calls) - 1
        return out

    def decode(self, tokens, cache):
        t = self._enter("decode")
        if self.t_open is None:
            self.t_open, self.t_close = t, t + self._seconds
        if self._on_decode is not None:
            self._on_decode(self)       # the tracer; its stop reads the trace
            t = self._clock()
        self._decode_rows = [(slot, rid, self.produced[rid])
                             for slot, rid in sorted(self.slot_rid.items())]
        logits, cache = self._call("decode", t, self._engine.decode, tokens,
                                   cache)
        if self._routes:
            self.decode_routes.append(self._drain_routes()[:, :, 0])
        self.decodes.append((tokens, self._decode_rows))
        self._last_logits = logits
        self._pending = len(self.calls) - 1
        return logits, cache

    def release(self, cache, slot):
        t = self._enter("release")
        rid = self.slot_rid.pop(slot)
        if self.produced[rid] >= self._gens[rid]:
            # the scheduler retires a request after a decode, so one asked
            # for a single token gets two
            self.finished[rid] = self.produced[rid]
            self.finals[rid] = torch.argmax(self._last_logits[slot])
            self.free_at[slot] = self.arrivals[rid][-1]
        else:
            self.early_releases += 1
        return self._call("release", t, self._engine.release, cache, slot)

    def short(self, slot, upto):
        return self._call("short", self._enter("short"), self._engine.short,
                          slot, upto)

    def grow_blocks(self, slot, n):
        return self._call("grow_blocks", self._enter("grow_blocks"),
                          self._engine.grow_blocks, slot, n)

    def grow_write(self, cache, slot, idx, block):
        return self._call("grow_write", self._enter("grow_write"),
                          self._engine.grow_write, cache, slot, idx, block)

    # -- what the window served ----------------------------------------------
    def served_tokens(self, rids: List[int]) -> Dict[int, List[int]]:
        """Each finished request's tokens, read back from the program's
        outputs (one host copy, after the window)."""
        want = set(rids)
        host = torch.stack([t for t, _ in self.decodes]).cpu().tolist()
        out: Dict[int, List[int]] = {r: [None] * self.finished[r] for r in want}
        for step, (_, rows) in zip(host, self.decodes):
            for slot, rid, j in rows:
                if rid in want and j >= 1:
                    out[rid][j - 1] = int(step[slot])
        for r in want:
            out[r][-1] = int(self.finals[r])
        return out

    def routes_of(self, rids: List[int]) -> Dict[int, Dict[int, torch.Tensor]]:
        """Each request's routing at every position fed to the model: its
        prompt's, then each decode's fed token's, in order;
        ``{rid: {layer: (positions, k) ids}}``, on the device."""
        want = set(rids)
        fed: Dict[int, List[torch.Tensor]] = {r: [] for r in want}
        for step, (_, rows) in zip(self.decode_routes, self.decodes):
            for slot, rid, j in rows:
                if rid in want and j >= 1:
                    fed[rid].append(step[:, slot])
        out = {}
        for r in want:
            ids = torch.cat([self.admit_routes[r]]
                            + [t[:, None] for t in fed[r]], dim=1)
            out[r] = dict(zip(self.route_layers, ids))
        return out
