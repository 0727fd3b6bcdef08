"""``DeviceEnvPool`` (``repro/core/device_pool.py``): the device engine
over the one-shard mesh.

The engine lives in ``core/engine.py``: one class, ``MeshEnvPool``, for
every mesh size.  ``DeviceEnvPool`` is that class; ``engine="device"``
is its ``num_shards=1`` mesh, and ``engine="device-sharded"`` the same
class over D shards (``core/sharded_pool.py``).

This module keeps the JAX package's import surface (``DeviceEnvPool``,
``PoolState``, ``derive_env_keys``, ``make_pool``) for drivers and
benchmarks.
"""

from __future__ import annotations

from repro_torch.core.engine import (
    MeshEnvPool,
    PoolState,
    derive_env_keys,
    make_pool,
)

DeviceEnvPool = MeshEnvPool

__all__ = [
    "DeviceEnvPool",
    "PoolState",
    "derive_env_keys",
    "make_pool",
]
