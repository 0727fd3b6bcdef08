"""Atomic, asynchronous checkpoints (``repro/checkpoint/store.py``), in
the JAX package's file layout so that a checkpoint crosses between the
two packages in either direction:

  * a checkpoint is a directory ``step_<n>/`` holding one ``.npy`` per
    tensor leaf and ``meta.json``;
  * a leaf's file is named by its path joined with ``__``, each part as
    ``jax.tree_util`` prints it: a dict key or a sequence index as is, a
    dataclass field as ``.name`` (``0__mean`` for NormalizeObs's running
    mean in a transform-state tuple);
  * a write goes to ``step_<n>.tmp/`` and is renamed when complete, so a
    crash mid-write never leaves a partial ``step_<n>``; the oldest
    steps beyond ``keep`` are then removed;
  * ``save_async`` copies the leaves to host memory at once and writes
    them on a daemon thread;
  * ``install_preemption_handler`` makes SIGTERM set ``preempted``, so a
    trainer saves at its next step boundary and exits.

A tree of DTensors (the model-parallel train state, ``launch/steps.py``)
is saved as full tensors: every rank takes part in gathering each leaf
(``full_tensor``, a collective, so every rank calls ``save``), and rank 0
alone writes, in the same layout, so a sharded run's checkpoint loads
into one process and into ``repro``.  ``restore`` with ``shardings``
(specs, ``distributed/sharding.py``) and their ``mesh`` gives each rank
its own shards of the full files, moving nothing between ranks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import signal
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.common import is_dtensor

_SEP = "__"


def _map_with_key(fn: Callable[[str, torch.Tensor], Any], tree: Any,
                  key: str | None = None) -> Any:
    """``tree`` with each tensor leaf replaced by ``fn(file key, leaf)``."""
    def sub(part: str, v: Any) -> Any:
        return _map_with_key(fn, v, part if key is None
                             else key + _SEP + part)

    if isinstance(tree, torch.Tensor):
        return fn(key, tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: sub("." + f.name, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)([sub(str(i), v) for i, v in enumerate(tree)])
    if isinstance(tree, dict):
        return {k: sub(str(k), v) for k, v in tree.items()}
    return tree


def _flatten(tree: Any) -> tuple[dict[str, np.ndarray], bool]:
    """The leaves as host arrays, and whether any was a DTensor (then
    gathered whole: a collective)."""
    flat: dict[str, np.ndarray] = {}
    sharded = []

    def put(key: str, leaf: torch.Tensor) -> torch.Tensor:
        if is_dtensor(leaf):
            sharded.append(key)
            leaf = leaf.full_tensor()
        flat[key] = leaf.detach().cpu().numpy()
        return leaf

    _map_with_key(put, tree)
    return flat, bool(sharded)


def _writes(sharded: bool) -> bool:
    """Whether this process writes: always for a tree of its own, only
    rank 0 of the job for a gathered DTensor tree."""
    if not sharded:
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


class CheckpointStore:
    """Checkpoints under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self.preempted = threading.Event()

    def install_preemption_handler(self) -> None:
        """SIGTERM sets ``preempted`` (call from the main thread)."""
        def handler(signum, frame):
            self.preempted.set()

        signal.signal(signal.SIGTERM, handler)

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in (
            re.fullmatch(r"step_(\d+)", name) for name in os.listdir(self.dir))
            if m)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree: Any, meta: dict | None = None) -> str:
        """Write ``tree`` at ``step`` now; a step already on disk stays."""
        self.wait()  # never race a pending write
        path = os.path.join(self.dir, f"step_{step}")
        flat, sharded = _flatten(tree)   # every rank gathers
        if step in self.steps() or not _writes(sharded):
            return path
        return self._write(step, flat, meta or {})

    def save_async(self, step: int, tree: Any, meta: dict | None = None
                   ) -> None:
        """Copy ``tree`` to the host now, write it on a thread."""
        self.wait()
        flat, sharded = _flatten(tree)
        if not _writes(sharded):
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, meta or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict[str, np.ndarray], meta: dict
               ) -> str:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for key, arr in flat.items():
            np.save(os.path.join(tmp, key + ".npy"), arr)
        meta = dict(meta, step=step, time=time.time(), n_leaves=len(flat))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)              # the atomic commit
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
        return final

    def restore(self, step: int, like: Any, shardings: Any = None,
                mesh: Any = None) -> Any:
        """The tree saved at ``step``, in the structure of ``like``, each
        leaf in its ``like`` leaf's dtype and on its device; with
        ``shardings`` (a spec tree) on ``mesh``, each leaf a DTensor laid
        out by its spec, every rank keeping its shard of the full
        file."""
        d = os.path.join(self.dir, f"step_{step}")

        def load(key: str, leaf: torch.Tensor) -> torch.Tensor:
            arr = np.load(os.path.join(d, key + ".npy"))
            if arr.dtype == np.uint32:   # JAX keys; torch keeps them int64
                arr = arr.astype(np.int64)
            # ascontiguousarray makes a 0-dim array 1-dim: keep its shape
            return torch.from_numpy(np.ascontiguousarray(arr)).reshape(
                arr.shape).to(dtype=leaf.dtype, device=leaf.device)

        tree = _map_with_key(load, like)
        if shardings is None:
            return tree
        from repro_torch.distributed.sharding import place

        return place(tree, shardings, mesh)

    def meta(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)


__all__ = ["CheckpointStore"]
