"""Host-side ActionBufferQueue and StateBufferQueue (paper Appendix D;
``repro/core/buffers.py``).

EnvPool's two queues are host memory, and so are these: numpy arrays
and Python lists, no tensors.  The C++ originals are lock-free via
std::atomic; CPython has no such primitive, so the *structure* is kept
(pre-allocated circular storage, semaphore signaling, slot acquisition
via monotonic counters — ``itertools.count`` whose ``next()`` is atomic
under the GIL) while a mutex guards the few compound updates.  What
matters for the engine comparison is what the paper highlights:
**zero-copy batching** — workers write observations straight into the
pre-allocated output block and ownership of a full block transfers to
the consumer without a copy.

Both queues enforce **bounded occupancy with blocking backpressure**: a
producer that gets more than the ring capacity ahead of the consumer
blocks (or raises ``TimeoutError`` with a ``timeout=``) instead of
silently overwriting unconsumed slots.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any

import numpy as np


def _acquire_many(sem: threading.Semaphore, n: int,
                  timeout: float | None, what: str) -> None:
    """Acquire ``n`` permits or none: on timeout the partial acquisition
    is rolled back and TimeoutError raised, so a failed put leaves the
    queue state untouched."""
    deadline = None if timeout is None else time.monotonic() + timeout
    for i in range(n):
        left = None if deadline is None else max(0.0, deadline - time.monotonic())
        ok = sem.acquire() if left is None else sem.acquire(timeout=left)
        if not ok:
            sem.release(i) if i else None
            raise TimeoutError(f"{what}: queue full (backpressure timeout)")


class ActionBufferQueue:
    """Pre-allocated circular queue of (env_id, action) work items.

    Capacity 2N as in the paper (App. D.1): at most N outstanding actions
    plus headroom; two monotonic counters track head/tail, a semaphore
    coordinates producers/consumers.  A second semaphore counts FREE
    slots: ``put_batch`` blocks (backpressure) when more than 2N items
    would be outstanding, so the ring can never wrap onto unconsumed
    slots.
    """

    def __init__(self, num_envs: int):
        self._capacity = 2 * num_envs
        self._buf: list[Any] = [None] * self._capacity
        self._head = itertools.count()   # dequeue positions
        self._tail = itertools.count()   # enqueue positions
        self._lock = threading.Lock()
        self._sem = threading.Semaphore(0)             # filled slots
        self._free = threading.Semaphore(self._capacity)  # empty slots

    def put_batch(self, items: list[Any], timeout: float | None = None) -> None:
        """Enqueue ``items``; blocks while the ring lacks free slots
        (``timeout=`` turns the block into TimeoutError).  An empty batch
        is a no-op — ``Semaphore.release(0)`` raises ValueError in
        CPython, and an env pool legitimately produces empty sends (e.g.
        an async recv served zero lanes of one shard)."""
        if not items:
            return
        if len(items) > self._capacity:
            raise ValueError(
                f"put_batch of {len(items)} items exceeds queue capacity "
                f"{self._capacity} (2 * num_envs) — it could never complete"
            )
        _acquire_many(self._free, len(items), timeout, "ActionBufferQueue")
        with self._lock:
            for item in items:
                self._buf[next(self._tail) % self._capacity] = item
        self._sem.release(len(items))

    def get(self, timeout: float | None = None) -> Any:
        if not self._sem.acquire(timeout=timeout):
            raise TimeoutError("ActionBufferQueue.get timed out")
        with self._lock:
            idx = next(self._head) % self._capacity
            item = self._buf[idx]
            self._buf[idx] = None
        self._free.release()
        return item


class _Block:
    """One StateBufferQueue block: batch_size pre-allocated slots."""

    def __init__(self, fields: dict[str, tuple[tuple[int, ...], Any]], batch: int):
        self._field_spec = fields
        self.batch = batch
        self.arrays: dict[str, np.ndarray] = {}
        self.ready = threading.Event()
        self._done = itertools.count()
        self.alloc()

    def alloc(self) -> None:
        """(Re-)allocate slot storage. Called on recycle: ownership of the
        previous arrays transferred to the consumer (paper App. D.2)."""
        self.arrays = {
            name: np.zeros((self.batch,) + shape, dtype)
            for name, (shape, dtype) in self._field_spec.items()
        }
        self.ready.clear()
        self._done = itertools.count()

    def _mark_done(self, n: int) -> None:
        last = 0
        for _ in range(n):
            last = next(self._done)
        if last == self.batch - 1:
            self.ready.set()

    def write(self, slot: int, values: dict[str, Any]) -> None:
        for name, v in values.items():
            self.arrays[name][slot] = v
        self._mark_done(1)

    def write_slice(self, lo: int, values: dict[str, Any]) -> None:
        """Write a contiguous run of slots in one numpy slice assignment
        (zero-copy batching: the batch lands straight in the block)."""
        n = 0
        for name, v in values.items():
            v = np.asarray(v)
            n = v.shape[0]
            self.arrays[name][lo:lo + n] = v
        self._mark_done(n)


class StateBufferQueue:
    """Circular buffer of pre-allocated blocks (paper App. D.2).

    Workers acquire slots first-come-first-served via a global monotonic
    counter; slot ``k`` lands in block ``(k // M) % num_blocks`` at offset
    ``k % M``.  A block whose M slots are written flips its ready event;
    ``take()`` consumes blocks in allocation order and recycles them.

    Occupancy is bounded: a free-slot semaphore makes ``acquire_slot`` /
    ``put_batch`` block once ``num_blocks * batch`` slots are outstanding
    (the consumer's ``take`` returns permits), so a fast producer can
    never wrap onto a block the consumer has not taken, the bound on the
    policy lag of ``rl/ppo.py::train_host_pipelined``.  ``put_batch`` is
    the batched producer: one slice write per block it lands in, split
    at the ring's end.
    """

    def __init__(
        self,
        fields: dict[str, tuple[tuple[int, ...], Any]],
        batch_size: int,
        num_envs: int,
    ):
        self.batch = batch_size
        # enough blocks that N outstanding results can never wrap onto an
        # unconsumed block
        self.num_blocks = max(2, -(-num_envs // batch_size) + 1)
        self._blocks = [_Block(fields, batch_size) for _ in range(self.num_blocks)]
        self._alloc = itertools.count()
        self._alloc_lock = threading.Lock()
        self._take_head = 0
        self._free = threading.Semaphore(self.num_blocks * self.batch)

    def acquire_slot(self, timeout: float | None = None) -> tuple[_Block, int]:
        _acquire_many(self._free, 1, timeout, "StateBufferQueue")
        with self._alloc_lock:
            k = next(self._alloc)
        return self._blocks[(k // self.batch) % self.num_blocks], k % self.batch

    def put_batch(self, values: dict[str, Any],
                  timeout: float | None = None) -> None:
        """Write a whole ``(m, ...)``-leading batch of rows in allocation
        order; blocks under backpressure like ``acquire_slot``.  Rows
        land contiguously (one slice write per block spanned)."""
        arrs = {name: np.asarray(v) for name, v in values.items()}
        m = next(iter(arrs.values())).shape[0] if arrs else 0
        if m == 0:
            return
        _acquire_many(self._free, m, timeout, "StateBufferQueue")
        with self._alloc_lock:
            k0 = next(self._alloc)
            for _ in range(m - 1):
                next(self._alloc)
        off = 0
        while off < m:
            k = k0 + off
            blk = self._blocks[(k // self.batch) % self.num_blocks]
            lo = k % self.batch
            run = min(self.batch - lo, m - off)
            blk.write_slice(lo, {n: v[off:off + run] for n, v in arrs.items()})
            off += run

    def take(self, timeout: float | None = None) -> dict[str, np.ndarray]:
        blk = self._blocks[self._take_head % self.num_blocks]
        if not blk.ready.wait(timeout=timeout):
            raise TimeoutError("StateBufferQueue.take timed out")
        out = blk.arrays  # ownership transfer — no copy
        blk.alloc()       # fresh storage for the recycled block
        self._take_head += 1
        self._free.release(self.batch)
        return out
