"""Atomic, async-capable checkpoints (port of
``repro/checkpoint/manager.py``, with its on-disk format).

  * **Contents**: logical (whole) arrays keyed by tree path, as the
    reference spells it (:func:`repro_torch.tree.keystr`), plus the step and
    an ``extra`` dict.  The trainer saves ``(params, opt_state)`` in the
    reference's stacked layout (:func:`repro_torch.bridge.to_jax_layout`),
    so a checkpoint either package writes restores in the other.
  * **Atomicity**: a save writes ``<dir>/step_N.tmp``, renames it to
    ``step_N`` and then replaces the ``latest`` pointer file; a crash
    mid-write never corrupts the restore point.  The oldest steps beyond
    ``keep`` are removed.
  * **Async**: ``save_async`` copies the tree to host memory at once and
    writes the files on a background thread.
  * **Preemption**: the trainer (``launch/train.py``) saves on SIGTERM at
    the end of the step the signal lands in.

Format: a MessagePack index (``index.msgpack``, written by the port's own
codec) and one ``.npy`` file per array.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch import tree as tu
from repro_torch.checkpoint import codec


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {tu.keystr(path): tu.host_copy(leaf)
            for path, leaf in tu.leaves_with_path(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None
             ) -> str:
        """Synchronous atomic save of a tree of tensors or arrays."""
        flat = _flatten(tree)
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = {"step": step, "extra": extra or {}, "arrays": {}}
        for key, arr in flat.items():
            fname = f"a{len(index['arrays'])}.npy"
            np.save(os.path.join(tmp, fname), arr)
            index["arrays"][key] = {"file": fname,
                                    "shape": list(arr.shape),
                                    "dtype": str(arr.dtype),
                                    "shard_of": None}
        with open(os.path.join(tmp, "index.msgpack"), "wb") as f:
            f.write(codec.packb(index))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, "latest.tmp"),
                   os.path.join(self.dir, "latest"))
        self._gc()
        return final

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> None:
        """Snapshot to host now; write on a background thread."""
        self.wait()                      # one in flight at a time
        host_tree = tu.tree_map(tu.host_copy, tree)
        self._thread = threading.Thread(
            target=self.save, args=(step, host_tree, extra), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "latest")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, step: Optional[int], like: Any
                ) -> Tuple[int, Any, Dict]:
        """Restore into the structure of ``like``, by path (not by leaf
        order); the leaves come back as numpy arrays."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "index.msgpack"), "rb") as f:
            index = codec.unpackb(f.read())
        leaves = [np.load(os.path.join(d, index["arrays"][tu.keystr(path)]
                                       ["file"]))
                  for path, _ in tu.leaves_with_path(like)]
        return step, tu.unflatten_like(like, leaves), index.get("extra", {})

    # ------------------------------------------------------------------ misc
    def _gc(self):
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
