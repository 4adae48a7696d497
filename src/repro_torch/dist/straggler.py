"""Windowed-median straggler watchdog (port of ``repro/dist/straggler.py``,
which imports no JAX; the port keeps its own copy).

The watchdog keeps a sliding window of recent step durations and flags a
step slower than ``threshold`` times the window's *median*: the median, so
that the flagged outliers cannot drag the baseline up fast enough to hide
a persistent slowdown.

The serving schedulers run it over their iterations, whose durations are
bimodal by design: an iteration that admitted or preempted a request paid
for a prefill and is expected to be slow.  ``observe(..., expect_slow=
True)`` exempts such a step: it is neither flagged nor added to the
window, so an injected or real delay stands out against steady decode
steps.  Detection is advisory: the watchdog never raises.
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import deque
from typing import Callable, Deque, List, Optional


@dataclasses.dataclass(frozen=True)
class StragglerReport:
    """One flagged step: how slow, against what baseline."""

    step: int
    seconds: float
    median: float          # the window median the step was judged against
    ratio: float           # seconds / median
    window: int            # observations in the window when flagged

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class StragglerWatchdog:
    """Flag steps slower than ``threshold`` x the windowed median duration.

    ``observe(step, seconds)`` records one step and returns a
    :class:`StragglerReport` when it is an outlier, else None.  The median
    is taken over the observations before this one, and at least
    ``min_history`` of them are needed, so the first steps never flag
    against an empty baseline.  ``on_straggler`` is called with each
    report, and every report stays in ``reports``.
    """

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 min_history: int = 1,
                 on_straggler: Optional[Callable[[StragglerReport], None]]
                 = None):
        if not (window >= 1 and threshold > 1.0 and min_history >= 1):
            raise ValueError(f"window {window}, threshold {threshold}, "
                             f"min_history {min_history}")
        self.window = window
        self.threshold = threshold
        self.min_history = min_history
        self.on_straggler = on_straggler
        self.reports: List[StragglerReport] = []
        self._durations: Deque[float] = deque(maxlen=window)

    def observe(self, step: int, seconds: float, *,
                expect_slow: bool = False) -> Optional[StragglerReport]:
        if expect_slow:
            # a known-slow step (admission prefill, preemption) is no
            # anomaly, and keeping it out of the window keeps the baseline
            return None
        report = None
        if len(self._durations) >= self.min_history:
            med = statistics.median(self._durations)
            if med > 0 and seconds > self.threshold * med:
                report = StragglerReport(step=step, seconds=seconds,
                                         median=med, ratio=seconds / med,
                                         window=len(self._durations))
        # flagged steps enter the window too: a persistent slowdown raises
        # the median and stops flagging; isolated spikes do not move it
        self._durations.append(seconds)
        if report is not None:
            self.reports.append(report)
            if self.on_straggler is not None:
                self.on_straggler(report)
        return report

    def summary(self) -> dict:
        """Aggregate view for the end of a run."""
        med = (statistics.median(self._durations)
               if self._durations else None)
        return {"observed": len(self._durations),
                "flagged": len(self.reports),
                "window_median_s": med,
                "worst_ratio": max((r.ratio for r in self.reports),
                                   default=None)}
