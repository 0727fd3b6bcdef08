"""Async selection policies (``repro/core/scheduler.py``): which M of
the N lanes each recv serves.

``SchedState`` holds the per-lane signals (phase, predicted cost,
enqueue tick) and the recv tick; the engine builds it as a view of its
``PoolState`` fields.  A policy maps them to one f32 priority per lane
(lower is served first); ``select`` takes the M lowest.

A pool of several shards (``core/engine.py::MeshEnvPool``) hands the
policy a view with a leading shard dim: ``phase``, ``cost`` and
``send_tick`` ``(D, n)`` and ``tick`` ``(D, 1)``.  The priorities are
elementwise and the selections sort the last dim, so every shard picks
its own M/D lanes in one call, as each shard of the JAX package's
``shard_map`` does.  Only ``HierarchicalScheduler`` communicates: one
gather of a ``(D, C)`` matrix of candidate costs across the shards,
through the pool's mesh (``EnvMesh.gather``).

Tie order is part of the stream.  The JAX package selects with
``lax.top_k(-priority, m)``, which keeps the lower index first among
equal values, and ties are the common case: the fifo READY band is
``-1e9 + send_tick`` in f32, and ulp(1e9) = 64, so every READY lane
within 64 ticks ties.  ``torch.topk`` promises no order among ties, so
``select`` is a stable ascending sort, and the priorities are computed
in f32 in the JAX package's op order.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_dataclass

WAITING_ACTION = 0   # result consumed; the agent owes an action
HAS_ACTION = 1       # action stored; step not yet executed
READY = 2            # unconsumed result available

_BIG = 1e9           # exactly representable in f32
# the hierarchical bands: READY (-2^22) < overdue (-2^20) < admitted (0)
# < deferred (2^20) < WAITING (2^22); powers of two small enough that f32
# still resolves unit steps of cost and age inside a band, and values in
# a band clipped to +-2^19 so that no band bleeds into the next
_CAP = float(2 ** 19)
_BAND = float(2 ** 20)
_EDGE = float(2 ** 22)
SCHEDULES = ("fifo", "sjf", "hierarchical")


@tree_dataclass
class SchedState:
    phase: torch.Tensor      # (N,) int32
    cost: torch.Tensor       # (N,) int32 predicted cost of the pending step
    send_tick: torch.Tensor  # (N,) int32 tick the action was enqueued
    tick: torch.Tensor       # () int32 recv counter


class Scheduler:
    """A policy: pure functions over ``SchedState``."""

    name = "base"

    def enqueue(self, ss: SchedState, lane_ids: torch.Tensor,
                costs: torch.Tensor) -> SchedState:
        """Lanes ``lane_ids`` received an action with predicted ``costs``."""
        ids = lane_ids.long()
        return ss.replace(
            phase=ss.phase.index_fill(0, ids, HAS_ACTION),
            cost=ss.cost.index_copy(0, ids, costs.to(torch.int32)),
            send_tick=ss.send_tick.index_copy(
                0, ids, ss.tick.expand(ids.shape).to(torch.int32)),
        )

    def select(self, ss: SchedState, m: int) -> torch.Tensor:
        """The ``m`` lanes to serve, lowest priority first, ties by lane
        index (see the module docstring)."""
        order = torch.sort(self.priority(ss), stable=True).indices
        return order[..., :m].to(torch.int32)

    def select_info(self, ss: SchedState, m: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(idx, overdue_admits)``: ``select``'s lanes and the int32
        count of lanes admitted through an overdue band this recv (the
        telemetry signal; one a shard), which fifo and sjf do not have."""
        return self.select(ss, m), torch.zeros(
            (), dtype=torch.int32, device=ss.phase.device)

    def select_ready(self, ss: SchedState, m: int) -> torch.Tensor:
        """Masked mode's pick: the READY lanes in ``send_tick`` order (the
        tick their step completed), ties by lane index, every other lane
        after them; the same for every policy."""
        prio = torch.where(ss.phase == READY,
                           ss.send_tick.to(torch.float32), _BIG)
        return torch.sort(prio, stable=True).indices[..., :m].to(
            torch.int32)

    def complete(self, ss: SchedState, idx: torch.Tensor) -> SchedState:
        """Served lanes go back to WAITING; the tick advances."""
        return ss.replace(phase=ss.phase.index_fill(0, idx.long(),
                                                    WAITING_ACTION),
                          tick=ss.tick + 1)

    def priority(self, ss: SchedState) -> torch.Tensor:
        """(N,) f32; READY lanes below every HAS_ACTION lane, WAITING
        lanes above everything."""
        raise NotImplementedError

    @staticmethod
    def _ready_band(ss: SchedState) -> torch.Tensor:
        return -_BIG + ss.send_tick.to(torch.float32)


class FifoScheduler(Scheduler):
    """READY first in enqueue order, then HAS_ACTION by predicted cost
    minus queue age (SJF softened by aging), WAITING last."""

    name = "fifo"
    aging = 1.0

    def priority(self, ss: SchedState) -> torch.Tensor:
        age = (ss.tick - ss.send_tick).to(torch.float32)
        has_p = ss.cost.to(torch.float32) - self.aging * age
        return torch.where(ss.phase == READY, self._ready_band(ss),
                           torch.where(ss.phase == HAS_ACTION, has_p, _BIG))


class SjfScheduler(Scheduler):
    """Pure shortest-job-first on the cost signal; no aging, so
    persistently expensive lanes starve while cheap work exists."""

    name = "sjf"

    def priority(self, ss: SchedState) -> torch.Tensor:
        return torch.where(
            ss.phase == READY, self._ready_band(ss),
            torch.where(ss.phase == HAS_ACTION,
                        ss.cost.to(torch.float32), _BIG))


class HierarchicalScheduler(Scheduler):
    """Cost-aware hierarchical top-M across the shards of a mesh pool.

    Each shard nominates its ``C = min(n, 2 m)`` cheapest lanes with an
    action (n lanes and m results a shard); one gather of that ``(D, C)``
    cost matrix, never of env data, gives every shard the same admission
    cost ``tau``, the (D m)-th cheapest nominee.  Bands, low to high:
    READY < overdue < admitted (cost <= tau, SJF with aging) < deferred
    (cost > tau) < WAITING.  A deferred lane of cost c is overdue once
    ``aging * (age + n // m) >= patience * c``: its deadline less one
    rotation of n/m ticks, so expensive lanes come due together and are
    served in one block.  A shard whose lanes are all deferred still
    serves its cheapest m."""

    name = "hierarchical"
    aging = 1.0

    def __init__(self, mesh: Any, num_shards: int, patience: float = 1.0):
        self.mesh = mesh
        self.num_shards = int(num_shards)
        self.patience = float(patience)

    def _tau(self, ss: SchedState, m: int) -> torch.Tensor:
        """The (D m)-th smallest of the gathered candidate costs."""
        c = min(ss.phase.shape[-1], 2 * m)
        eff = torch.where(ss.phase == HAS_ACTION,
                          ss.cost.to(torch.float32), _BIG)
        cands = self.mesh.gather(torch.sort(eff, dim=-1).values[..., :c],
                                 "candidates")
        return torch.sort(cands.reshape(-1)).values[self.num_shards * m - 1]

    def select(self, ss: SchedState, m: int) -> torch.Tensor:
        return self.select_info(ss, m)[0]

    def select_info(self, ss: SchedState, m: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        tau = self._tau(ss, m)
        age = (ss.tick - ss.send_tick).to(torch.float32)
        cost = ss.cost.to(torch.float32)
        serviceable = ss.phase == HAS_ACTION
        admitted = serviceable & (cost <= tau)
        slack = float(ss.phase.shape[-1] // max(m, 1))
        overdue = serviceable & ~admitted & (
            self.aging * (age + slack) >= self.patience * cost)
        sjf_aged = torch.clamp(cost - self.aging * age, -_CAP, _CAP)
        pri = torch.where(
            ss.phase == READY,
            -_EDGE + torch.clamp_max(ss.send_tick.to(torch.float32), _CAP),
            torch.where(overdue, -_BAND + sjf_aged, torch.where(
                admitted, sjf_aged, torch.where(
                    serviceable, _BAND + torch.clamp_max(cost, _CAP),
                    _EDGE))))
        idx = torch.sort(pri, stable=True).indices[..., :m]
        return idx.to(torch.int32), overdue.gather(-1, idx).sum(
            -1, dtype=torch.int32)


def get_scheduler(schedule: str = "fifo", mesh: Any = None,
                  num_shards: int | None = None,
                  patience: float = 1.0) -> Scheduler:
    """Resolve a policy name.
    ``hierarchical`` is the cross-shard policy: it needs the pool's
    ``mesh`` and ``num_shards``, which the sharded engine gives it.
    ``patience`` is its fairness knob, which fifo and sjf accept and do
    not use."""
    if patience <= 0:
        raise ValueError(f"patience must be > 0, got {patience}")
    if schedule == "fifo":
        return FifoScheduler()
    if schedule == "sjf":
        return SjfScheduler()
    if schedule == "hierarchical":
        if mesh is None or num_shards is None:
            raise ValueError(
                "schedule='hierarchical' is the cross-shard policy: it "
                "needs a device mesh (use engine='device-sharded')")
        return HierarchicalScheduler(mesh, num_shards, patience=patience)
    raise ValueError(f"unknown schedule {schedule!r}; known: {SCHEDULES}")


# ---------------------------------------------------------------------- #
# host (numpy) mirror: ThreadEnvPool's work-queue ordering
# ---------------------------------------------------------------------- #
def numpy_priority(schedule: str, cost: np.ndarray) -> np.ndarray:
    """Host mirror of the policy priorities for lanes being enqueued;
    lower is pulled by a worker earlier.  ``fifo`` returns zeros (the
    caller's enqueue order is the host pool's native FIFO); ``sjf``
    orders by the per-lane cost estimate, with no aging term, like
    ``SjfScheduler``."""
    cost = np.asarray(cost, np.float32)
    if schedule == "fifo":
        return np.zeros_like(cost)
    if schedule == "sjf":
        return cost
    raise ValueError(
        f"no host mirror for schedule {schedule!r}; known: ('fifo', 'sjf')")


__all__ = [
    "HAS_ACTION", "READY", "SCHEDULES", "WAITING_ACTION", "FifoScheduler",
    "HierarchicalScheduler", "SchedState", "Scheduler", "SjfScheduler",
    "get_scheduler",
    "numpy_priority",
]
