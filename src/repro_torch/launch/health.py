"""Serving health record: the run's operational trail (port of
``repro/launch/health.py``, which imports no JAX; the port keeps its own
copy).

Over-committed serving is only operable if every degradation leaves a
trace: a preemption, an expired deadline, a NaN-retired slot, a straggling
step or an injected fault lands here as a counter or an event, and the
whole record is written as one JSON document per run (``serve.py
--metrics-json``).  The record lives on the host and is append-only: it
never touches the device path, so turning it on cannot change a token.

    counters   preemptions / resumes / resumed_tokens_replayed /
               deadline_cancelled / nan_retired / faults_injected /
               admissions / admission_stalls (spec_parks on the
               speculative path; replay_splices, a replayed token that
               came out other than recorded, only if that ever happens)
    pools      num_blocks / high_water / live_at_end / peak_live_fraction
               per pool
    stragglers StragglerReport.to_dict() of every flagged step
    faults     the injected-fault records of launch.faults
    events     (kind, step, detail) trail of every degradation
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List


class ServeHealth:
    """Append-only health record of one serving run."""

    def __init__(self) -> None:
        self.counters: Dict[str, int] = {
            "preemptions": 0,
            "resumes": 0,
            "resumed_tokens_replayed": 0,
            "deadline_cancelled": 0,
            "nan_retired": 0,
            "faults_injected": 0,
            "admissions": 0,
            "admission_stalls": 0,
        }
        self.pools: Dict[str, Dict[str, Any]] = {}
        self.stragglers: List[dict] = []
        self.faults: List[dict] = []
        self.events: List[dict] = []

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def event(self, kind: str, step: int, **detail: Any) -> None:
        self.events.append({"kind": kind, "step": step, **detail})

    def straggler(self, report) -> None:
        """Takes a :class:`repro_torch.dist.straggler.StragglerReport`."""
        self.stragglers.append(report.to_dict())

    def fault(self, record: dict) -> None:
        self.faults.append(record)
        self.count("faults_injected")

    def pool(self, tag: str, allocator) -> None:
        """Snapshot one :class:`repro_torch.core.paged_kv.BlockAllocator`."""
        usable = max(allocator.num_blocks - 1, 1)   # less the trash block
        self.pools[tag] = {
            "num_blocks": allocator.num_blocks,
            "high_water": allocator.high_water,
            "live_at_end": allocator.live_count,
            "peak_live_fraction": allocator.high_water / usable,
        }

    def to_dict(self) -> dict:
        return {
            "counters": dict(self.counters),
            "pools": {k: dict(v) for k, v in self.pools.items()},
            "stragglers": list(self.stragglers),
            "faults": list(self.faults),
            "events": list(self.events),
        }

    def write_json(self, path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True))
        return p
