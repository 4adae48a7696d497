"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Set-up is everything before the window: the imports, the kernels' build
(once per checkout, cached in it), the weights drawn on the device from
the seed, ``make_engine``, the engine's warm-up on the traffic's first
(and longest) prompt, and every client's first request admitted.  The
window drives ``launch/scheduler.py::run_schedule`` (greedy) over the
engine through :class:`spans.SpanEngine` and closes after ``seconds``.
Then ``correct``: a sample of the requests finished in the window, drawn
from the seed with the longest in it, is run through the plain reference
once the program's state is freed, and every served token's reference
logit is held against the reference's best at that position.  For a
configuration with routed experts (its adapter's ``routed``), the
program's routing is recorded through the window (``spans.py``), the
reference follows it at every position, and the routing is held against
the reference's own router by itself (``max_layer_route_gap``).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import devtrace
import measure
import spans
import spec
import traffic
import weights

KERNELS = ("splitmax_attn", "splitmax_decode")


def check_sample(sp, mix: Dict, seed: int) -> List[int]:
    """The longest finished request, then others in an order drawn from
    the seed, until ``check_tokens`` served tokens or ``check_requests``
    requests."""
    done = sorted(sp.finished)
    if not done:
        return []
    first = max(done, key=lambda r: (sp.finished[r], -r))
    rest = [r for r in done if r != first]
    rest = [rest[i] for i in np.random.default_rng([seed, 2]).permutation(len(rest))]
    pick, n = [first], sp.finished[first]
    for r in rest:
        if n >= mix["check_tokens"] or len(pick) >= mix["check_requests"]:
            break
        pick.append(r)
        n += sp.finished[r]
    return pick


def sequences(prompts, served: Dict[int, List[int]]):
    """What the reference reads for the requests ``served``: each one's
    prompt and served tokens but its last, judged at every served token's
    position, and request 0's prompt after them, judged nowhere, where it
    is not served (it set the pool's scales).  Returns (the request of
    each sequence, the sequences, their prompt lengths, the calibrating
    sequence's index, the positions judged)."""
    rids = list(served)
    seqs, plens, at = [], [], []
    for r in rids:
        p = prompts[r]
        seqs.append(np.concatenate([p, np.asarray(served[r][:-1], np.int64)]))
        plens.append(len(p))
        at.append(range(len(p) - 1, len(p) - 1 + len(served[r])))
    if 0 not in rids:
        rids.append(0)
        seqs.append(prompts[0])
        plens.append(len(prompts[0]))
        at.append([])
    return rids, seqs, plens, rids.index(0), at


def reference_gaps(W: Dict, conf: Dict, prompts, served: Dict[int, List[int]],
                   routes: Optional[Dict] = None, low=None) -> Dict:
    """Each served token's gap below the reference's best logit at its
    position: the widest and the mean over the tokens judged.  With
    ``routes`` (``SpanEngine.routes_of``, request 0's among them), the
    reference follows the program's routing, and ``max_layer_route_gap``
    is the largest over MoE layers of the mean amount, over every position,
    by which that routing departs from the reference's own, so that a
    router that errs in one layer shows.  With ``low``
    (the control), the reference at ``low``'s precision routes by itself
    and puts a token first at each position; the f32 reference follows
    that routing, and the gaps are those of that routing and those
    tokens."""
    ref = spec.reference_module(conf["reference"])
    keys, seqs, plens, calib, at = sequences(prompts, served)
    follow = None
    if routes is not None:
        follow = [{layer: ids[:len(s)] for layer, ids in routes[r].items()}
                  for r, s in zip(keys, seqs)]
    picks = None
    if low is not None:
        lo = ref.logits_at(W, conf, seqs, plens, calib, at, low=low)
        picks = [o.argmax(-1) for o in lo["logits"]]
        follow = lo["routes"] if any(lo["routes"]) else None
        del lo
    out = ref.logits_at(W, conf, seqs, plens, calib, at, routes=follow)
    gaps = []
    for i, r in enumerate(served):
        lg = out["logits"][i]
        tok = (picks[i] if picks is not None else
               torch.as_tensor(served[r], device=lg.device))
        gaps.append(lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0])
    g = torch.cat(gaps)
    res = {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
           "tokens": int(g.numel()), "flips": int((g > 0).sum())}
    if follow is not None:
        res["max_layer_route_gap"] = max(out["route_gap_layers"])
    return res


def run_cell(bench: Dict, cell: Dict, seed: int, seconds: float, trace: bool,
             *, t_start: float, device: str = "cuda",
             conf: Optional[Dict] = None, mix: Optional[Dict] = None,
             wrap: Optional[Callable] = None,
             extra: Optional[Callable] = None,
             probe: Optional[Callable] = None) -> Dict:
    """``conf`` and ``mix`` replace the cell's files (the tests' small
    sizes); ``wrap`` wraps the engine (the tests' planted faults);
    ``extra(W, conf, prompts, served, routes)`` runs after the check (the
    control's readings); ``probe()`` reads the card as the window closes."""
    clock = time.perf_counter
    conf = conf or spec.load_config(bench, cell["config"])
    mix = mix or spec.load_traffic(cell["traffic"])
    limits = spec.load_limits(cell["name"])
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import cuda_build
        cuda_build.build(KERNELS)
    prompts, gens = traffic.make_requests(mix, seed, conf["config"]["vocab_size"])
    W = weights.make_weights(conf, seed, dev)
    system = spec.system_module(conf["system"])
    routed = system.routed(conf)
    engine = system.make_engine(conf, W, prompts, slots=mix["clients"],
                                max_len=traffic.max_len(mix))
    if wrap is not None:
        engine = wrap(engine)
    tracer = None
    if trace:
        devtrace.warm()
        tracer = devtrace.Tracer(seconds, clock)
    sp = spans.SpanEngine(engine, gens, seconds, clock=clock, on_decode=tracer,
                          routes=routed)
    from repro_torch.launch.scheduler import run_schedule
    try:
        run_schedule(sp, prompts, gens=gens, warmup=True)
        raise spans.TrafficDrained("the schedule ended inside the window")
    except spans.WindowClosed:
        pass
    finally:
        sp.stop_routes()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    at_close = probe() if probe is not None else None
    setup_s = sp.t_open - t_start
    e2e = measure.end_to_end(sp, seconds)
    tr = tracer.read(sp.calls) if tracer is not None else None
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    plens = [len(p) for p in prompts]
    ctx = measure.context(sp, conf, plens, mix["clients"], tr)
    sample = check_sample(sp, mix, seed)
    served = sp.served_tokens(sample)
    routes = sp.routes_of(sample + [0]) if routed and served else None
    counters = {"early_releases": sp.early_releases,
                "admission_stalls": sp.admission_stalls,
                "finished": len(sp.finished), "checked_requests": len(sample),
                "card_at_close": at_close,
                "route_bytes": sum(t.nbytes for t in [
                    *sp.admit_routes.values(), *sp.decode_routes]),
                **{k: e2e[k] for k in ("tokens", "itl_gaps", "ttft_requests")}}
    del engine, sp, tracer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = clock()
    chk = reference_gaps(W, conf, prompts, served, routes) if served else None
    counters["check_s"] = clock() - t_check
    if extra is not None and served:
        counters["extra"] = extra(W, conf, prompts, served, routes)
    return {"setup_s": setup_s, "e2e": e2e, "ctx": ctx, "trace": tr,
            "peak": peak, "check": chk, "limits": limits,
            "counters": counters}


def judge(chk: Optional[Dict], lim: Dict):
    """``correct`` and the numbers compared: every number of ``lim`` at or
    under its limit (a check that read nothing is not correct)."""
    got = {k: (chk[k] if chk else float("inf")) for k in lim}
    return chk is not None and all(got[k] <= lim[k] for k in lim), got


def result_line(bench: Dict, cell: Dict, out: Dict, trace: bool,
                device_kind: str) -> Dict:
    """The last line: ``correct``, ``attempted``, ``failed``, the metrics
    of the run's kind, ``device`` and (traced) ``breakdown``; the numbers
    compared, beside their limits, last."""
    lim = out["limits"]
    correct, got = judge(out["check"], lim)
    c = out["counters"]
    metrics = {}
    if trace:
        for m in spec.metrics_for(bench, cell["name"], "per_layer"):
            v = spec.metric_reader(m["name"])(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": out["setup_s"], **out["e2e"]}
        for m in spec.metrics_for(bench, cell["name"], "end_to_end"):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": cell["chips"],
              "memory_peak_bytes": out["peak"]}
    line = {"correct": correct, "attempted": out["e2e"]["attempted"],
            "failed": c["early_releases"], "metrics": metrics,
            "device": device}
    if trace and out["trace"] is not None:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                             "idle_gaps": out["trace"]["idle_gaps"]}
    line["check"] = {k: {"value": got[k], "limit": lim[k]} for k in lim}
    return line
