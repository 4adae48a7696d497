"""Seeded fault injection for the serving schedulers (port of
``repro/launch/faults.py``).

Each hook forces one failure mode the schedulers claim to survive, at an
exact step, so a chaos run is reproducible and its recovery can be
asserted token for token:

* **pool exhaustion**: at step N every free block is stolen from the pool
  and held for ``hold`` steps, so growth and admission hit
  :class:`repro_torch.core.paged_kv.BlockAllocationError` and the
  scheduler must preempt or stall until the blocks come back;
* **scheduler delay**: step N is stretched by ``seconds`` of host sleep,
  which the serving loop's straggler watchdog must flag;
* **NaN logits**: at step N one slot's logits become NaN before token
  selection; the finite guard must retire that request;
* **forced preemption**: at step N one named slot is preempted as if the
  pool had run dry.

Plans are built in code (:class:`FaultPlan`) or from the environment
(:meth:`FaultPlan.from_env`), with the reference's knobs:

    REPRO_FAULT_EXHAUST=<step>[:<hold>]     steal all free blocks at <step>,
                                            return them <hold> steps later
                                            (default hold 4)
    REPRO_FAULT_DELAY=<step>:<seconds>      sleep <seconds> before <step>
    REPRO_FAULT_NAN=<step>[:<slot>]         NaN the logits of <slot>
                                            (default 0) at <step>
    REPRO_FAULT_PREEMPT=<step>[:<slot>]     force-preempt <slot> (default 0)
                                            at <step>
    REPRO_FAULT_SEED=<int>                  recorded in the plan

Every fault that fires is recorded through the run's
:class:`repro_torch.launch.health.ServeHealth`.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import torch

from repro_torch.core import paged_kv


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The faults to inject into one run; unset knobs stay inert."""

    exhaust_step: Optional[int] = None
    exhaust_hold: int = 4
    delay_step: Optional[int] = None
    delay_seconds: float = 0.0
    nan_step: Optional[int] = None
    nan_slot: int = 0
    preempt_step: Optional[int] = None
    preempt_slot: int = 0
    seed: int = 0

    @classmethod
    def from_env(cls, env=os.environ) -> "FaultPlan":
        """Parse the ``REPRO_FAULT_*`` knobs."""

        def step_and(name, default):
            parts = env[name].split(":")
            return int(parts[0]), (type(default)(parts[1]) if len(parts) > 1
                                   else default)

        kw = {}
        for name, step_key, arg_key, default in (
                ("REPRO_FAULT_EXHAUST", "exhaust_step", "exhaust_hold", 4),
                ("REPRO_FAULT_NAN", "nan_step", "nan_slot", 0),
                ("REPRO_FAULT_PREEMPT", "preempt_step", "preempt_slot", 0)):
            if env.get(name):
                kw[step_key], kw[arg_key] = step_and(name, default)
        if env.get("REPRO_FAULT_DELAY"):
            step_s, sec_s = env["REPRO_FAULT_DELAY"].split(":")
            kw["delay_step"], kw["delay_seconds"] = int(step_s), float(sec_s)
        return cls(seed=int(env.get("REPRO_FAULT_SEED", "0")), **kw)

    @property
    def armed(self) -> bool:
        return (self.exhaust_step is not None or self.delay_step is not None
                or self.nan_step is not None
                or self.preempt_step is not None)


class FaultInjector:
    """Runs a :class:`FaultPlan` inside a serving loop.  With an empty plan
    every hook is a comparison and nothing else, so the injector stays
    wired into every run."""

    def __init__(self, plan: Optional[FaultPlan] = None, health=None):
        self.plan = plan or FaultPlan()
        self.health = health
        self._stolen: List[int] = []
        self._steal_step: Optional[int] = None

    def _record(self, kind: str, step: int, **detail) -> None:
        if self.health is not None:
            self.health.fault({"kind": kind, "step": step, **detail})

    def on_step(self, step: int) -> None:
        """At the top of each scheduler iteration: the delay fault."""
        p = self.plan
        if p.delay_step is not None and step == p.delay_step:
            time.sleep(p.delay_seconds)
            self._record("delay", step, seconds=p.delay_seconds)

    def squeeze_pool(self, step: int,
                     alloc: paged_kv.BlockAllocator) -> None:
        """Steal every free block at the armed step and give them back
        ``exhaust_hold`` steps later; in between, growth and admission see
        an exhausted pool and take their pressure paths."""
        p = self.plan
        if self._stolen and step >= self._steal_step + p.exhaust_hold:
            alloc.free(self._stolen)
            self._record("exhaust_release", step,
                         returned=len(self._stolen))
            self._stolen, self._steal_step = [], None
        if p.exhaust_step is not None and step == p.exhaust_step \
                and not self._stolen:
            self._stolen = alloc.alloc(alloc.free_count)
            self._steal_step = step
            self._record("exhaust", step, stolen=len(self._stolen),
                         hold=p.exhaust_hold)

    def force_preempt(self, step: int) -> Optional[int]:
        """The slot to preempt at this step whatever the pool holds, or
        None.  The scheduler checks that the slot is active; the fault is
        recorded here, so a firing on an idle slot shows too."""
        p = self.plan
        if p.preempt_step is not None and step == p.preempt_step:
            self._record("forced_preempt", step, slot=p.preempt_slot)
            return p.preempt_slot
        return None

    def corrupt_logits(self, step: int, logits: torch.Tensor) -> torch.Tensor:
        """At the armed step, a new tensor with the slot's row (all of its
        tokens' logits on the speculative path) set to NaN; ``logits``
        itself, which a step may own, is never written."""
        p = self.plan
        if p.nan_step is not None and step == p.nan_step:
            row = torch.arange(logits.shape[0], device=logits.device)
            mask = (row == p.nan_slot).view(-1, *[1] * (logits.dim() - 1))
            logits = torch.where(mask, torch.nan, logits)
            self._record("nan", step, slot=p.nan_slot)
        return logits

    def drain(self, alloc: paged_kv.BlockAllocator) -> None:
        """Return any blocks still held at the end of a run: chaos must
        never be the source of a leak."""
        if self._stolen:
            alloc.free(self._stolen)
            self._stolen, self._steal_step = [], None
