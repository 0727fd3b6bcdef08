"""``ShardedDeviceEnvPool`` (``repro/core/sharded_pool.py``): the mesh
engine of ``core/engine.py`` with its mesh defaulting to every shard the
process or job holds, one a process (``make_env_mesh()``).

``engine="device"`` is this engine at one shard (``DeviceEnvPool``)
and ``engine="device-sharded"`` the same class over D shards.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.engine import EnvMesh, MeshEnvPool, make_env_mesh
from repro_torch.envs.base import Environment


def ShardedDeviceEnvPool(env: Environment, num_envs: int,
                         batch_size: int | None = None,
                         mode: str | None = None,
                         mesh: EnvMesh | int | None = None,
                         batched: bool | None = None,
                         schedule: str = "fifo", sched_patience: float = 1.0,
                         transforms: Any = (), obs: bool = True,
                         device: torch.device | str | None = None
                         ) -> MeshEnvPool:
    """The mesh engine over ``mesh`` (an ``EnvMesh`` or a shard count on
    ``device``), by default one shard a process.  N and M are global;
    N % D == 0 and M % D == 0."""
    return MeshEnvPool(env, num_envs, batch_size, mode=mode,
                       mesh=make_env_mesh(mesh, device), batched=batched,
                       schedule=schedule, sched_patience=sched_patience,
                       transforms=transforms, obs=obs)


__all__ = ["EnvMesh", "MeshEnvPool", "ShardedDeviceEnvPool",
           "make_env_mesh"]
