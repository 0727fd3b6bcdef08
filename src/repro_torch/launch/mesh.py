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

``make_debug_mesh`` is the model-parallel steps' ``("data", "model")``
``DeviceMesh`` over the job's processes (``launch/steps.py``).  The TPU
v5e roofline constants of ``repro``'s module are not carried over: the
card's are in ``distributed/analytic.py``.  ``repro``'s
``make_production_mesh`` (16 x 16 and 2 x 16 x 16 devices) waits for
ROADMAP A19b; its plans need no devices (``distributed/sharding.py``
takes a mesh's shape).
"""

from __future__ import annotations

import os
from typing import Any

import torch

from repro_torch.core.device import resolve_device
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


def make_debug_mesh(devices: int | None = None,
                    device: torch.device | str | None = None) -> Any:
    """A ``DeviceMesh`` named ``("data", "model")`` over the job's
    processes, one device each, shaped by ``repro``'s rule: ``model`` is
    2 when the process count n is even and above 1, else 1, and
    ``data`` is n / model.  Without a process group it joins one: the
    job torchrun describes in the environment (``WORLD_SIZE`` above 1,
    ``init_method="env://"``), else a group of this process alone, over
    ``nccl`` on the card and ``gloo`` on the CPU.  It runs on the card
    unless ``device`` is the CPU.  ``devices``, if given, must be the
    process count."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if dev.type == "cuda":
            index = dev.index if dev.index is not None else int(
                os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
            torch.cuda.set_device(index)
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0)
    n = dist.get_world_size()
    if devices is not None and int(devices) != n:
        raise ValueError(f"devices={devices}: the job has {n} processes, "
                         "one device each")
    model = 2 if n % 2 == 0 and n > 1 else 1
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))


__all__ = ["initialize_multihost", "make_debug_mesh", "make_env_mesh",
           "multihost_info"]
