"""The traced run's device trace: ``torch.profiler`` (CUPTI, device
activity only, so that the host pays little for it) over a bounded span of
whole iterations inside the window, read in memory (no trace file is
written).  An idle gap on the device is labelled by the harness span the
host was in at its middle (``spans.SpanEngine``'s calls, moved onto the
trace's clock, nanoseconds since the epoch), or ``scheduler`` outside
every call.

The span opens at the first decode after ``START`` of the window and
closes at the first decode after it holds ``MIN_ITERS`` iterations and
``MIN_ADMITS`` admissions, or after ``STOP`` of the window.  Both ends lie
where the scheduler has just read its tokens to the host, so the device
work in the span is that of the calls made in it.
"""
from __future__ import annotations

import bisect
import re
import sys
import time
from typing import Dict, List, Optional

import torch

START, STOP = 0.25, 0.75
MIN_ITERS, MIN_ADMITS = 24, 2
TOP = 10


def warm() -> None:
    """Start and stop the profiler once, in set-up, so that the span does
    not pay CUPTI's first initialisation."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Tracer:
    """Called at each decode's entry (``SpanEngine(on_decode=...)``)."""

    def __init__(self, seconds: float, clock):
        self.seconds = seconds
        self.clock = clock
        self.prof = None
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None
        self.iters = 0
        self.admits0 = 0

    def __call__(self, sp) -> None:
        if self.t_stop is not None:
            return
        now = self.clock()
        elapsed = now - sp.t_open
        admits = len(sp.admit_calls)
        if self.prof is None:
            if elapsed >= START * self.seconds:
                from torch.profiler import ProfilerActivity, profile
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
                self.t_start = self.clock()
                self.offset_ns = time.time_ns() - int(self.t_start * 1e9)
                self.admits0 = admits
            return
        self.iters += 1
        if ((self.iters >= MIN_ITERS and admits - self.admits0 >= MIN_ADMITS)
                or elapsed >= STOP * self.seconds):
            self.t_stop = self.clock()
            self.prof.stop()

    def read(self, calls: List[tuple]) -> Optional[Dict]:
        """Device busy time, kernel time by name, and the breakdown (the
        harness's ``calls`` label the idle gaps); None when the span never
        opened."""
        if self.t_stop is None:
            if self.prof is None:
                return None
            self.t_stop = self.clock()
            self.prof.stop()
        dev = []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.duration_ns() > 0:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name()))
        self.prof = None
        host = []
        for kind, t_in, t_out, t_arr in calls:
            end = t_arr if kind in ("admit", "decode") else t_out
            if end is not None and self.t_start <= t_in < self.t_stop:
                host.append((int(t_in * 1e9) + self.offset_ns,
                             int(end * 1e9) + self.offset_ns, kind))
        lo, hi = (int(t * 1e9) + self.offset_ns
                  for t in (self.t_start, self.t_stop))
        inside = sum(lo <= a and b <= hi for a, b, _ in dev)
        print(f"trace: {len(dev)} device events, {inside} inside the span "
              f"on the host's clock, {len(host)} harness spans",
              file=sys.stderr)
        return summarize(dev, host, self.t_stop - self.t_start,
                         self.t_start, self.t_stop)


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 120
    characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:120]


def summarize(dev: List[tuple], host: List[tuple], window_s: float,
              t_start: float, t_stop: float) -> Dict:
    dev.sort()
    by_name: Dict[str, float] = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    merged: List[List[int]] = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-9
    host.sort()
    starts = [h[0] for h in host]
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = host[i][2] if i >= 0 and host[i][1] >= mid else "scheduler"
        gaps.append((b - a, label, (a - merged[0][0]) * 1e-9))
    gaps.sort(reverse=True)
    ops: Dict[str, float] = {}
    for name, s in by_name.items():
        ops[short_name(name)] = ops.get(short_name(name), 0.0) + s
    return {
        "busy_s": busy, "window_s": window_s, "t_start": t_start,
        "t_stop": t_stop, "by_name": by_name,
        "device_ops": sorted(([n, s] for n, s in ops.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": [[f"{label} at +{at:.3f} s", g * 1e-9]
                      for g, label, at in gaps[:TOP]],
    }


def kernel_seconds(trace: Dict, pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(s for name, s in trace["by_name"].items() if rx.search(name))
