"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
under ``kernels/_build/`` (listed in ``.gitignore``), named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one is
reused.  Nothing is built at import time: the first launch builds, or a
caller (``chip_smoke.py``) builds every kernel up front with
:func:`build`, one ``nvcc`` process per source, all started together.

There is no fallback: a missing ``nvcc`` or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from repro_torch import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("splitmax_attn", "splitmax_decode", "splitmax_verify",
           "splitmax_verify_tiles", "splitmax_verify_tiles_pad",
           "int8_matmul", "w8_linear")

# No --use_fast_math: quantize divides by the scale and rounds half to even,
# and the requant multiply must round to nearest; fast math changes both.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


@functools.lru_cache(maxsize=None)
def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the flags, its
    source and every shared header (read once a process)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named source that has no current library; returns each
    compiled source's ``nvcc`` output (``-Xptxas -v`` register report).
    Each compile is a ``build`` span (``repro_torch/trace.py``) of its own
    ``nvcc``'s wall time."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_name(f"{out.name}.{os.getpid()}.log"), "w+")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, log, time.perf_counter(), subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
    logs = {}
    pending = list(jobs)
    while pending:                 # each source's own wall time
        for job in list(pending):
            if job[5].poll() is not None:
                trace.record("build", job[4], time.perf_counter(),
                             source=job[0])
                pending.remove(job)
        time.sleep(0.05)
    for name, out, tmp, log, _, proc in jobs:
        log.seek(0)
        text = log.read()
        log.close()
        os.unlink(log.name)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{text}")
        os.replace(tmp, out)           # atomic: concurrent builds agree
        logs[name] = text
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
