"""Scheduler (``launch/scheduler.py::run_schedule``): the median host time
per iteration (decode entry to decode entry) spent outside the engine's
calls, from the harness's spans."""
from measure import median


def read(ctx):
    m = median(ctx["sched_self_s"])
    return None if m is None else m * 1e3
