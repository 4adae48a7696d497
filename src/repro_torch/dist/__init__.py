"""Distributed-execution helpers of the port (``repro/dist``); the
straggler watchdog so far."""
