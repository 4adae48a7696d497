"""The port's span recorder: the one place the program records where its
host time goes, in memory, for a caller that asks.  It imports nothing of
the port, so every layer (kernels, models, launch) can record into it.

    with trace.span("engine.admit", rid=rid, slot=slot):   # a span
        ...
    s = trace.span("sched.iteration", start=ts_iter, step=step)
    ...
    s.end(t)                          # a span on stamps the caller took
    trace.enable(); ...; out = trace.drain(); trace.disable()

A span records its name, an id, the id of the span open around it (its
parent), its attributes and its start and end from
``time.perf_counter_ns()``; ``rid`` is a request's id, shared by the spans
of one request.  :func:`drain` hands over what was recorded and clears it,
with every stamp moved onto the clock of ``torch.profiler``'s events
(nanoseconds since the Unix epoch, :func:`profiler_offset_ns`), so a span
can be laid over a device trace.

Off (the default), :func:`span` tests one module-level flag and returns a
shared object that does nothing: no clock is read and nothing is kept.
On, a span that ends appends its fields to flat integer arrays and a list
of names (its attributes kept only where it has any), so a long traced
span leaves few objects for the garbage collector to scan.  On or off, the
recorder never synchronises the device, copies a tensor to the host or
runs a tensor op; a tensor it keeps (:func:`routing`) stays where it is.
Nothing switches it on but a caller of :func:`enable`.

What the spans are, where they open and which metric reads each:
``PERF.md`` §3.
"""
from __future__ import annotations

import time
from array import array
from typing import Dict, List, Optional

_on = False
_stack: List["_Span"] = []        # the spans open now, innermost last
# the ended spans, a field an array; parent 0 is none
_names: List[str] = []
_ids = array("q")
_parents = array("q")
_t0 = array("q")
_t1 = array("q")
_attrs: Dict[int, Dict] = {}      # by index, the spans that have attributes
_routes: List[Dict] = []
_next_id = 0


class _Off:
    """What :func:`span` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, at: Optional[float] = None) -> None:
        pass


OFF = _Off()


def _ns(t: Optional[float]) -> int:
    """A ``time.perf_counter()`` reading in seconds, or now, as
    ``perf_counter_ns``."""
    return time.perf_counter_ns() if t is None else int(round(t * 1e9))


class _Span:
    __slots__ = ("name", "id", "parent", "t0", "attrs")

    def __init__(self, name: str, t0: int, attrs: Dict):
        global _next_id
        _next_id += 1
        self.name, self.id, self.t0, self.attrs = name, _next_id, t0, attrs
        self.parent = _stack[-1].id if _stack else 0
        _stack.append(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def end(self, at: Optional[float] = None) -> None:
        """Close the span at ``at`` (a ``perf_counter()`` reading the
        caller already took) or now.  A span that the recorder was switched
        off under is dropped."""
        if _stack and _stack[-1] is self:
            _stack.pop()
        elif self in _stack:
            del _stack[_stack.index(self):]
        if _on:
            if self.attrs:
                _attrs[len(_names)] = self.attrs
            _names.append(self.name)
            _ids.append(self.id)
            _parents.append(self.parent)
            _t0.append(self.t0)
            _t1.append(_ns(at))


def span(name: str, *, start: Optional[float] = None, **attrs):
    """A span named ``name`` with ``attrs``, open from ``start`` (a
    ``time.perf_counter()`` reading the caller already took) or now until
    the ``with`` block ends or :meth:`end` is called."""
    if not _on:
        return OFF
    return _Span(name, _ns(start), attrs)


def record(name: str, start: float, end: float, **attrs) -> None:
    """A span that already ended, on the caller's ``perf_counter()``
    stamps, inside the span open now."""
    if _on:
        _Span(name, _ns(start), attrs).end(end)


def routing(top_idx, margin) -> None:
    """A MoE layer's routing: each token's top-k expert ids and the margin
    of its k-th over its (k+1)-th router logit, kept by reference on their
    device, tagged with the ``i`` of the ``model.layer`` span open now."""
    if not _on:
        return
    layer = next((s.attrs.get("i") for s in reversed(_stack)
                  if s.name == "model.layer"), None)
    _routes.append({"layer": layer, "idx": top_idx, "margin": margin})


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True
    del _stack[:]


def disable() -> None:
    global _on
    _on = False
    del _stack[:]


def profiler_offset_ns() -> int:
    """``perf_counter_ns`` to the clock of ``torch.profiler``'s events,
    nanoseconds since the Unix epoch: the tightest of a few brackets of
    ``time.time_ns()`` between two ``perf_counter_ns()`` reads."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def drain() -> Dict:
    """Everything recorded since the last drain, then cleared: ``spans``
    (dicts of ``name``, ``id``, ``parent`` (None at the top), ``t0``,
    ``t1``, ``attrs``) in the order they ended, stamps on the profiler's
    clock; ``routes`` (:func:`routing`)."""
    off = profiler_offset_ns()
    spans = [{"name": n, "id": i, "parent": p or None, "t0": a + off,
              "t1": b + off, "attrs": _attrs.get(k, {})}
             for k, (n, i, p, a, b) in enumerate(
                 zip(_names, _ids, _parents, _t0, _t1))]
    routes = list(_routes)
    del _names[:], _ids[:], _parents[:], _t0[:], _t1[:], _routes[:]
    _attrs.clear()
    return {"spans": spans, "routes": routes}
