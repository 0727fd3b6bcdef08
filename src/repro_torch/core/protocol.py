"""The ``EnvPool`` protocol (``repro/core/protocol.py``): one front end
over every engine.

An engine has specs (``spec``, ``num_envs``, ``batch_size``) and the
paper's §3.1 API (``send``, ``recv``, ``step``, ``reset``) plus
``stats()``.  There are two calling conventions underneath:

* **functional** engines (``DeviceEnvPool``, ``MeshEnvPool``): functions of an explicit
  ``PoolState`` — ``send(ps, actions, ids) -> ps``, ``recv(ps) -> (ps,
  TimeStep)``, ``reset(key) -> (ps, TimeStep)`` — with ``init`` and
  ``xla()``;
* **host** engines (``ThreadEnvPool``, ``ForLoopEnv``,
  ``SubprocessEnv``): stateful objects, ``send(actions, ids)``,
  ``recv() -> dict``, ``reset() -> dict``; the dict's values are
  tensors on the pool's device, and ``send`` takes numpy or tensors on
  any device.

``bind(pool)`` hides the difference behind one stateful handle whose
``reset``/``step``/``send``/``recv`` all return ``TimeStep`` blocks.
The JAX package's handle jits the functional engine's methods; here
they are called as they are.

Multi-process contract (``launch/mesh.py``, ``core/engine.py::
MeshEnvPool``, ``distributed/sharding.py``).  After
``initialize_multihost(coordinator, num_processes, process_id,
backend=...)`` a ``MeshEnvPool`` may span the processes of the job, one
device each: every process runs the same driver and calls the pool's
methods in the same order, and each holds its own D/P shards.

* **env state**: every ``PoolState`` leaf holds the process's own lanes
  and shards; it never crosses processes on a recv.  ``recv`` returns
  the process's own block of M/P rows, shard-major, with global
  ``env_id``s, and ``send`` takes it back in that order.
* **collectives on a recv**: exactly two families, both of fixed size,
  independent of env count and observation size: the hierarchical
  schedule's gather of the ``(D, C)`` candidate costs and
  ``NormalizeObs``' gathers of its ``(D, *obs)`` moment sums.  The mesh
  counts every collective it issues (``EnvMesh.log``), in solo too,
  where a gather is the local block itself; a fifo or sjf pool without
  ``NormalizeObs`` issues none.  Over gloo a CUDA tensor is staged
  through the host, a round trip a collective.
* **host reads**: ``stats(ps)`` and any read of remote rows go through
  ``pool.replicate`` (a gather of every leaf), an explicit call off the
  recv; the counters' per-shard integer sums keep the snapshot bitwise
  the same at every process count.
* **disaggregation** (``rl/ppo.py::train_disaggregated``): the env
  shards live on the env processes' mesh
  (``distributed.sharding.disaggregated_env_mesh``), the learner's
  update on its own process; the rollout and the params cross by
  ``host_broadcast`` (staged on the CPU) once an iteration each way,
  and the consumed rollout is one policy step stale, as in
  ``train_pipelined``, which V-trace corrects.
* **transform-state checkpoints**: saved in the canonical form (all N
  rows, one copy of the global statistics) by the mesh's first process,
  restored at any shard and process count.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

from repro_torch import random
from repro_torch.core.specs import EnvSpec, TimeStep


@runtime_checkable
class EnvPool(Protocol):
    """The structural contract every engine satisfies."""

    spec: EnvSpec
    num_envs: int
    batch_size: int

    def send(self, *args: Any, **kwargs: Any) -> Any: ...

    def recv(self, *args: Any, **kwargs: Any) -> Any: ...

    def step(self, *args: Any, **kwargs: Any) -> Any: ...

    def reset(self, *args: Any, **kwargs: Any) -> Any: ...

    def stats(self, *args: Any, **kwargs: Any) -> Any: ...


@runtime_checkable
class FunctionalEnvPool(EnvPool, Protocol):
    """Engines over an explicit state: also ``init`` (key -> PoolState)
    and the ``xla()`` handle API."""

    def init(self, key: Any) -> Any: ...

    def xla(self, *args: Any, **kwargs: Any) -> Any: ...


def is_functional(pool: Any) -> bool:
    """True for the device engine (explicit ``PoolState``)."""
    return isinstance(pool, FunctionalEnvPool)


def to_timestep(out: dict[str, Any] | TimeStep) -> TimeStep:
    """A host engine's recv dict as a ``TimeStep``."""
    if isinstance(out, TimeStep):
        return out
    return TimeStep(**{k: out[k] for k in (
        "obs", "reward", "done", "terminated", "truncated", "env_id",
        "episode_return", "episode_length", "step_cost")})


class BoundEnvPool:
    """One stateful handle over any ``EnvPool``; it owns the rollout
    state (the ``PoolState`` of a functional engine):

        h = bind(pool, key)
        ts = h.reset()
        ts = h.step(actions, ts.env_id)   # or h.send(...); h.recv()
    """

    def __init__(self, pool: EnvPool, key: Any = None, seed: int = 0):
        self.pool = pool
        self.spec = pool.spec
        self.num_envs = pool.num_envs
        self.batch_size = pool.batch_size
        self.functional = is_functional(pool)
        self._ps = None
        if self.functional:
            self._key = key if key is not None else random.PRNGKey(seed)

    @property
    def state(self):
        """The functional engine's ``PoolState`` (None for host ones)."""
        return self._ps

    def reset(self) -> TimeStep:
        if self.functional:
            self._ps, ts = self.pool.reset(self._key)
            return ts
        pool = self.pool
        if hasattr(pool, "async_reset") and pool.batch_size < pool.num_envs:
            pool.async_reset()
            return to_timestep(pool.recv())
        return to_timestep(pool.reset())

    def send(self, actions: Any, env_ids: Any) -> None:
        if self.functional:
            self._ps = self.pool.send(self._ps, actions, env_ids)
        else:
            self.pool.send(actions, env_ids)

    def recv(self) -> TimeStep:
        if self.functional:
            self._ps, ts = self.pool.recv(self._ps)
            return ts
        return to_timestep(self.pool.recv())

    def step(self, actions: Any, env_ids: Any) -> TimeStep:
        if self.functional:
            self._ps, ts = self.pool.step(self._ps, actions, env_ids)
            return ts
        return to_timestep(self.pool.step(actions, env_ids))

    def stats(self) -> dict:
        """The engine's counters: a functional engine's read off the
        owned ``PoolState``."""
        if self.functional:
            return self.pool.stats(self._ps)
        return self.pool.stats()

    def close(self) -> None:
        if hasattr(self.pool, "close"):
            self.pool.close()


def bind(pool: EnvPool, key: Any = None, seed: int = 0) -> BoundEnvPool:
    """The stateful view of any engine (see ``BoundEnvPool``)."""
    return BoundEnvPool(pool, key=key, seed=seed)


__all__ = [
    "BoundEnvPool", "EnvPool", "FunctionalEnvPool", "bind", "is_functional",
    "to_timestep",
]
