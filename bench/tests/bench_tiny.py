"""Small sizes of the benchmark's cells for the CPU tests: the cell's own
configuration and traffic files with their widths, depth, vocabulary and
lengths cut, run through the same harness on the CPU (the port's plain
kernels) in float32."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import cell  # noqa: E402
import spec  # noqa: E402

CELLS = ("deepseek-67b-int8.chat", "deepseek-moe-16b.code")


def tiny(name: str, dtype: str = "float32"):
    bench = spec.load_benchmark()
    c = spec.workload(bench, name)
    conf = copy.deepcopy(spec.load_config(bench, c["config"]))
    cc = conf["config"]
    gqa = cc["num_key_value_heads"] < cc["num_attention_heads"]
    cc.update(hidden_size=64, num_attention_heads=4,
              num_key_value_heads=2 if gqa else 4, num_hidden_layers=3,
              intermediate_size=128, vocab_size=512)
    if "n_routed_experts" in cc:
        cc.update(n_routed_experts=8, num_experts_per_tok=3,
                  moe_intermediate_size=32)
    conf["serve"]["dtype"] = dtype
    mix = dict(spec.load_traffic(c["traffic"]))
    mix.update(clients=4, prompt_len={"dist": "loguniform", "lo": 8, "hi": 40},
               gen_len={"dist": "uniform", "lo": 3, "hi": 9}, block=8,
               requests=20000, check_tokens=400, check_requests=64)
    return bench, c, conf, mix


def run(name: str, seed: int = 2 ** 31 + 7, wrap=None, extra=None,
        dtype: str = "float32", seconds: float = 1.0):
    bench, c, conf, mix = tiny(name, dtype)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the test runner's workers share the cores
    try:
        out = cell.run_cell(bench, c, seed, seconds, False,
                            t_start=time.perf_counter(), device="cpu",
                            conf=conf, mix=mix, wrap=wrap, extra=extra)
    finally:
        torch.set_num_threads(threads)
    return bench, c, out
