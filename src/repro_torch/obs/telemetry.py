"""In-engine counters (``repro/obs/telemetry.py``): the ``Telemetry``
dataclass of int32 tensors on ``PoolState``.

The pool counts itself on the card: the counters ride on ``PoolState``
like ``tf_state``, are updated inside recv (and masked mode's tick) as
fixed-size integer ops, and reach the host only through an explicit
``pool.stats()`` snapshot, never on the hot path.  They never feed env
math, scheduling or RNG, so the served streams are the same with them
on or off.

Counter semantics (the JAX package's):

  * ``serves[i]``      — times lane ``i`` was served in a recv block;
  * ``wait_ticks[i]``  — recv ticks lane ``i``'s results waited between
    becoming available (action enqueued, or, in masked mode, step
    completed) and being served, summed;
  * ``wait_hist``      — fixed-edge histogram of those per-serve waits
    (edges ``WAIT_EDGES``, the last bucket open-ended);
  * ``served``         — served result slots (recvs x M);
  * ``stepped``        — served results produced by an env step;
  * ``cost_sum``       — substeps (``step_cost``) of stepped results;
  * ``overdue_admits`` — lanes admitted through a scheduler's overdue
    band (0 under fifo and sjf).

A pool of several shards (``core/engine.py::MeshEnvPool``) keeps the
counters that are not per lane (``PER_SHARD_FIELDS``) with a leading
shard dim, one partial sum a shard, and ``snapshot_device`` sums them
on the host: no collective is ever issued for the counters.  Counts are
integer adds, exact in any order, so the counters are bitwise the JAX
package's at every shard and process count; like JAX's int32 they
wrap.  The JAX package
avoids scatters (XLA:CPU serializes a scatter with duplicate indices)
with an (M, N) one-hot per recv; here a block's lanes are distinct, so
the per-lane counts are one ``index_add`` each.

``HostTelemetry`` is the numpy mirror the host engines keep
(``core/host_pool.py``, ``core/baselines.py``): the same counters with
the same semantics, so their ``stats()`` equal the device engine's.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_dataclass

# bucket b counts waits in [WAIT_EDGES[b], WAIT_EDGES[b+1]); the last
# bucket is open-ended
WAIT_EDGES: tuple[int, ...] = (0, 1, 2, 4, 8, 16, 32, 64)
NUM_BUCKETS = len(WAIT_EDGES)

# the counters that are not per lane: the JAX package carries them with a
# leading shard dim of 1 on its PoolState
PER_SHARD_FIELDS = (
    "wait_hist", "served", "stepped", "cost_sum", "overdue_admits")


@tree_dataclass
class Telemetry:
    """The counters, all int32."""

    serves: torch.Tensor          # (N,) per-lane serve count
    wait_ticks: torch.Tensor      # (N,) per-lane summed queue-wait ticks
    wait_hist: torch.Tensor       # (NUM_BUCKETS,) wait histogram
    served: torch.Tensor          # () served result slots
    stepped: torch.Tensor         # () served results backed by a step
    cost_sum: torch.Tensor        # () substeps of stepped results
    overdue_admits: torch.Tensor  # () overdue-band admissions


def init_telemetry(num_envs: int, device: torch.device | str
                   ) -> Telemetry:
    """Zeroed counters for ``num_envs`` lanes on ``device``."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    n = int(num_envs)
    return Telemetry(serves=zeros(n), wait_ticks=zeros(n),
                     wait_hist=zeros(NUM_BUCKETS), served=zeros(),
                     stepped=zeros(), cost_sum=zeros(),
                     overdue_admits=zeros())


@functools.lru_cache(maxsize=None)
def _edges(device: torch.device) -> torch.Tensor:
    return torch.tensor(WAIT_EDGES, dtype=torch.int32, device=device)


def _hist_counts(wait: torch.Tensor) -> torch.Tensor:
    """Per-bucket counts of one block's waits over its last dim:
    ``count[b] = #(wait >= edge[b]) - #(wait >= edge[b+1])``."""
    cum = (wait[..., None] >= _edges(wait.device)).sum(-2, dtype=torch.int32)
    return cum - torch.cat([cum[..., 1:], cum.new_zeros(
        cum.shape[:-1] + (1,))], dim=-1)


def record_serve(tele: Telemetry, idx: torch.Tensor, wait: torch.Tensor,
                 stepped_mask: torch.Tensor, step_cost: torch.Tensor,
                 overdue_admits: torch.Tensor, full_block: bool = False
                 ) -> Telemetry:
    """One recv block's update.  ``idx`` (M,) served lane rows, distinct;
    ``wait`` (M,) ticks each result waited; ``stepped_mask`` (M,) results
    backed by an env step, whose ``step_cost`` is counted;
    ``overdue_admits`` a 0-dim int32.  ``full_block``: the block serves
    every lane and ``wait`` is in lane order (sync mode), so the
    per-lane counts are whole-vector adds.  With a leading shard dim the
    block's tensors are (D, M/D) and ``overdue_admits`` (D,): the
    per-shard sums then gain one entry a shard."""
    wait = wait.to(torch.int32)
    flat = wait.reshape(-1)
    if full_block:
        serves = tele.serves + 1
        wait_ticks = tele.wait_ticks + flat
    else:
        ids = idx.reshape(-1).long()
        serves = tele.serves.index_add(0, ids, torch.ones_like(flat))
        wait_ticks = tele.wait_ticks.index_add(0, ids, flat)
    return tele.replace(
        serves=serves,
        wait_ticks=wait_ticks,
        wait_hist=tele.wait_hist + _hist_counts(wait),
        served=tele.served + idx.shape[-1],
        stepped=tele.stepped + stepped_mask.sum(-1, dtype=torch.int32),
        cost_sum=tele.cost_sum + torch.where(
            stepped_mask, step_cost.to(torch.int32), 0).sum(
                -1, dtype=torch.int32),
        overdue_admits=tele.overdue_admits + overdue_admits.to(torch.int32),
    )


def record_finished(tele: Telemetry, finished: torch.Tensor,
                    cost: torch.Tensor) -> Telemetry:
    """Masked mode's substep accounting for the lanes whose step
    completed this tick; their serve is recorded later, by
    ``record_serve`` with no stepped lanes."""
    return tele.replace(
        stepped=tele.stepped + finished.sum(-1, dtype=torch.int32),
        cost_sum=tele.cost_sum + torch.where(
            finished, cost.to(torch.int32), 0).sum(-1, dtype=torch.int32),
    )


def format_stats(recvs: int, serves: Any, wait_ticks: Any, wait_hist: Any,
                 served: int, stepped: int, cost_sum: int,
                 overdue_admits: int) -> dict:
    """The ``pool.stats()`` dict, keys and derived values as the JAX
    package's."""
    served, stepped = int(served), int(stepped)
    wait_ticks = np.asarray(wait_ticks, np.int64)
    return {
        "recvs": int(recvs),
        "served": served,
        "stepped": stepped,
        "occupancy": (stepped / served) if served else 0.0,
        "cost_sum": int(cost_sum),
        "overdue_admits": int(overdue_admits),
        "serves": np.asarray(serves, np.int64),
        "wait_ticks": wait_ticks,
        "wait_ticks_total": int(wait_ticks.sum()),
        "wait_hist": np.asarray(wait_hist, np.int64),
        "wait_edges": list(WAIT_EDGES),
    }


def snapshot_device(tele: Telemetry, tick: torch.Tensor) -> dict:
    """The host snapshot of ``tele``; ``tick`` is the recv count (one a
    shard, all equal).  Per-shard partial sums (a leading shard dim) are
    summed here, as integers.  This is the only host transfer telemetry
    makes."""
    host = {k: getattr(tele, k).cpu().numpy() for k in (
        "serves", "wait_ticks", *PER_SHARD_FIELDS)}
    if host["wait_hist"].ndim == 2:
        for k in PER_SHARD_FIELDS:
            host[k] = host[k].astype(np.int64).sum(0)
    return format_stats(recvs=int(tick.reshape(-1)[0]), **host)


def stats_to_jsonable(stats: dict) -> dict:
    """A JSON-safe copy of a ``stats()`` dict (arrays as lists)."""
    return {k: v.tolist() if isinstance(v, np.ndarray) else v
            for k, v in stats.items()}


class HostTelemetry:
    """Numpy mirror of ``Telemetry`` for the host engines.

    The pool records what it enqueues (``on_enqueue`` tags each lane's
    outstanding work item as a step or a reset) and what it serves
    (``record_block`` once per recv block), so the counters carry the
    exact semantics of the device engine's, including the step/reset
    distinction the served block alone cannot reveal.
    """

    def __init__(self, num_envs: int):
        n = int(num_envs)
        self.num_envs = n
        self.serves = np.zeros(n, np.int64)
        self.wait_ticks = np.zeros(n, np.int64)
        self.wait_hist = np.zeros(NUM_BUCKETS, np.int64)
        self.served = 0
        self.stepped = 0
        self.cost_sum = 0
        self.overdue_admits = 0
        self.tick = 0
        self._send_tick = np.zeros(n, np.int64)
        self._kind_step = np.zeros(n, bool)

    def on_enqueue(self, env_ids, stepped: bool) -> None:
        """Lanes received work (an action, or a reset when ``stepped``
        is False) at the current tick."""
        ids = np.asarray(env_ids, np.int64)
        self._send_tick[ids] = self.tick
        self._kind_step[ids] = stepped

    def record_block(self, env_ids, step_cost) -> None:
        """One recv block was served; advances the tick (the host
        mirror of ``Scheduler.complete``)."""
        ids = np.asarray(env_ids, np.int64)
        wait = self.tick - self._send_tick[ids]
        self.serves[ids] += 1
        self.wait_ticks[ids] += wait
        buckets = np.sum(
            wait[:, None] >= np.asarray(WAIT_EDGES[1:], np.int64)[None, :],
            axis=1)
        np.add.at(self.wait_hist, buckets, 1)
        self.served += int(ids.size)
        stepped = self._kind_step[ids]
        self.stepped += int(stepped.sum())
        self.cost_sum += int(np.asarray(step_cost, np.int64)[stepped].sum())
        self.tick += 1

    def snapshot(self) -> dict:
        return format_stats(
            recvs=self.tick, serves=self.serves, wait_ticks=self.wait_ticks,
            wait_hist=self.wait_hist, served=self.served,
            stepped=self.stepped, cost_sum=self.cost_sum,
            overdue_admits=self.overdue_admits)


__all__ = [
    "NUM_BUCKETS", "PER_SHARD_FIELDS", "WAIT_EDGES", "HostTelemetry",
    "Telemetry",
    "format_stats", "init_telemetry", "record_finished", "record_serve",
    "snapshot_device", "stats_to_jsonable",
]
