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
``DeviceMesh`` over the job's processes (``launch/steps.py``), and
``make_production_mesh`` ``repro``'s 16 x 16 and 2 x 16 x 16 meshes
over a job of 256 or 512 processes (``launch/dryrun.py`` builds it
over a fake process group; the plans alone need no devices:
``distributed/sharding.py`` takes a mesh's shape).  Where ``repro``
keeps its TPU v5e roofline constants, this module keeps the card's:
H100 SXM, one process a card.
"""

from __future__ import annotations

import math
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


# H100 SXM roofline constants, per card (NVIDIA H100 data sheet, SXM5,
# 700 W): dense bf16 tensor-core FLOP/s, HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, and NVLink 4's bytes/s a card (18 links of
# 25 GB/s each way: 450 GB/s each way, 900 GB/s both ways, the data
# sheet's figure), the rate a collective between cards of one host
# moves at; ``repro``'s ``ICI_BW``
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
PEAK_FLOPS_F32 = 67e12
NVLINK_BW = 450e9

# repro's production meshes: axis names -> shape
PRODUCTION_MESHES = {False: (("data", "model"), (16, 16)),
                     True: (("pod", "data", "model"), (2, 16, 16))}


def _join(dev: torch.device, solo: bool) -> None:
    """Join a process group if none is up: the job torchrun describes in
    the environment (``WORLD_SIZE`` above 1, ``init_method="env://"``),
    else, with ``solo``, a group of this process alone; over ``nccl`` on
    the card (this process's card: ``dev``'s index, else ``LOCAL_RANK``
    modulo the cards) and ``gloo`` on the CPU."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else int(
            os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
        torch.cuda.set_device(index)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, init_method="env://")
    elif solo:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device | str | None = None) -> Any:
    """``repro``'s production ``DeviceMesh``: ``("data", "model")`` 16 x
    16, or with ``multi_pod`` ``("pod", "data", "model")`` 2 x 16 x 16,
    over a job of exactly 256 or 512 processes, one device each (the
    job's group, or torchrun's, joined as ``make_debug_mesh`` joins it).
    Any other job size raises ``ValueError``.  It runs on the card
    unless ``device`` is the CPU (or the job's backend is ``"fake"``,
    the dry run's, where no device computes)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    names, shape = PRODUCTION_MESHES[bool(multi_pod)]
    need = math.prod(shape)
    dev = None
    if not (dist.is_initialized() and dist.get_backend() == "fake"):
        dev = resolve_device(device)
        _join(dev, solo=False)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n != need:
        raise ValueError(
            f"the {'x'.join(map(str, shape))} production mesh needs a job "
            f"of {need} processes, one device each; this job has {n}")
    return init_device_mesh(dev.type if dev is not None else "cpu", shape,
                            mesh_dim_names=names)


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
    _join(dev, solo=True)
    n = dist.get_world_size()
    if devices is not None and int(devices) != n:
        raise ValueError(f"devices={devices}: the job has {n} processes, "
                         "one device each")
    model = 2 if n % 2 == 0 and n > 1 else 1
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))


__all__ = ["HBM_BW", "NVLINK_BW", "PEAK_FLOPS_BF16", "PEAK_FLOPS_F32",
           "PRODUCTION_MESHES", "initialize_multihost", "make_debug_mesh",
           "make_env_mesh", "make_production_mesh", "multihost_info"]
