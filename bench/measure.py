"""The numbers a run reports, from the harness's spans (``spans.py``) and,
in a traced run, the device trace (``trace.py``).

End to end (every rate and tail over all the work in the window):

* ``tok_s``: output tokens that reached the host inside the window, over
  the window's seconds;
* ``itl_p95_ms``: the 95th percentile of every gap between two consecutive
  output tokens of one request, both inside the window (an admission that
  stalls the batch lengthens the gaps of every other request);
* ``ttft_p90_ms``: the 90th percentile, over requests sent inside the
  window, of the time from sending to the first token on the host.

The per-layer readers (``bench/metrics/*.py``) take :func:`context`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _pct(xs: List[float], p: float) -> Optional[float]:
    return float(np.percentile(np.asarray(xs), p)) if xs else None


def end_to_end(sp, seconds: float) -> Dict:
    lo, hi = sp.t_open, sp.t_close
    tokens = sum(lo <= t <= hi for arr in sp.arrivals.values() for t in arr)
    gaps = [b - a for arr in sp.arrivals.values() for a, b in zip(arr, arr[1:])
            if lo <= a and b <= hi]
    ttft = [arr[0] - sp.sent[rid] for rid, arr in sp.arrivals.items()
            if sp.sent.get(rid) is not None and lo <= sp.sent[rid]
            and arr and arr[0] <= hi]
    attempted = sum(any(lo <= t <= hi for t in arr)
                    for arr in sp.arrivals.values())
    return {"tok_s": tokens / seconds, "attempted": attempted,
            "itl_p95_ms": _pct(gaps, 95) * 1e3 if gaps else None,
            "ttft_p90_ms": _pct(ttft, 90) * 1e3 if ttft else None,
            "tokens": tokens, "itl_gaps": len(gaps), "ttft_requests": len(ttft)}


def context(sp, conf: Dict, prompt_lens: List[int], slots: int,
            trace: Optional[Dict]) -> Dict:
    """What the per-layer readers read: the window's admissions and decodes
    (entry, arrival and shapes), its iterations, and the trace."""
    lo, hi = sp.t_open, sp.t_close
    admits, decodes = [], []
    k = 0
    for kind, t_in, t_out, t_arr in sp.calls:
        if kind == "decode":
            rows = sp.decodes[k][1]
            k += 1
            if t_arr is not None and lo <= t_in and t_arr <= hi:
                lens = [1] * slots
                for slot, rid, j in rows:
                    lens[slot] = prompt_lens[rid] + j
                decodes.append({"t_in": t_in, "t_arr": t_arr, "lens": lens,
                                "live": [prompt_lens[rid] + j
                                         for _, rid, j in rows]})
    for rid, i in sp.admit_calls.items():
        _, t_in, _, t_arr = sp.calls[i]
        if t_arr is not None and lo <= t_in and t_arr <= hi:
            admits.append({"t_in": t_in, "t_arr": t_arr,
                           "prompt_len": prompt_lens[rid]})
    # host time per iteration (decode entry to decode entry) outside every
    # engine call, an admission's and a decode's up to their tokens' arrival
    self_s, covered, start = [], 0.0, None
    for kind, t_in, t_out, t_arr in sp.calls:
        if kind == "decode":
            if start is not None and lo <= start and t_in <= hi:
                self_s.append(max(0.0, (t_in - start) - covered))
            start, covered = t_in, 0.0
        end = t_arr if kind in ("admit", "decode") else t_out
        if start is not None and end is not None:
            covered += end - t_in
    return {"conf": conf, "config": conf["config"], "slots": slots,
            "window_s": hi - lo, "admits": admits, "decodes": decodes,
            "sched_self_s": self_s, "trace": trace}


def median(xs: List[float]) -> Optional[float]:
    return float(np.median(xs)) if xs else None
