"""Multi-process launch (``repro/launch/mesh.py``): join the processes
of a job over ``torch.distributed`` and build the env mesh over them.

Every process runs the same driver program.  After
``initialize_multihost`` each process holds one card (or the CPU), and
``make_env_mesh`` deals a pool's D shards to the processes in order, so
a ``MeshEnvPool`` on that mesh spans them with no change to the engine
(the contract: ``core/protocol.py``).  The backend is the caller's
choice, by name: ``nccl`` when every process has a card of its own,
``gloo`` on the CPU or when processes share a card (NCCL refuses two
ranks on one card); nothing picks another.  The JAX package's
``force_host_device_count`` has no counterpart here: D shards of one
process share its device (``make_env_mesh(D)`` without a job).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.engine import make_env_mesh

# the address ``initialize_multihost`` joined, for provenance
_COORDINATOR: str | None = None


def initialize_multihost(coordinator: str, num_processes: int,
                         process_id: int, *, backend: str,
                         device: int | None = None) -> tuple[int, int]:
    """Join this process into a job of ``num_processes`` as rank
    ``process_id``, over a TCP store at ``coordinator`` (``host:port``
    of rank 0; ``localhost:<port>`` on one machine), with collective
    ``backend`` (``"nccl"`` or ``"gloo"``).  With a card present it
    sets this process's card: ``device``, by default ``process_id``
    modulo the cards visible.  Returns ``(rank, world size)``."""
    import torch.distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count()
                              if device is None else device)
    elif backend == "nccl":
        raise RuntimeError("backend='nccl' needs a card; use 'gloo'")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    global _COORDINATOR
    _COORDINATOR = coordinator
    return dist.get_rank(), dist.get_world_size()


def multihost_info() -> dict[str, Any]:
    """``process_count``, ``process_id``, ``coordinator`` and ``backend``
    of this process (1, 0, None, None outside a job)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return {"process_count": 1, "process_id": 0, "coordinator": None,
                "backend": None}
    return {"process_count": dist.get_world_size(),
            "process_id": dist.get_rank(), "coordinator": _COORDINATOR,
            "backend": dist.get_backend()}


__all__ = ["initialize_multihost", "make_env_mesh", "multihost_info"]
