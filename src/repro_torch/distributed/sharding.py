"""Policy placement and the actor/learner hand-off
(``repro/distributed/sharding.py``, its multi-process part).

``policy_shardings`` is the JAX package's Seed-RL placement rule as a
plan: a policy smaller than ``min_shard_params`` is replicated on every
shard; a larger one over a mesh of several shards would put each leaf's
largest divisible dim on the mesh (FSDP over the env mesh).  The port
places replicated policies only (``rl/policy_lm.py::place_params``): a
sharded policy across processes waits for the model-parallel steps
(ROADMAP A19).  ``disaggregated_env_mesh`` and ``host_broadcast`` are
``rl/ppo.py::train_disaggregated``'s env mesh and hand-off.
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np
import torch

from repro_torch.core.engine import EnvMesh, make_env_mesh
from repro_torch.utils.tree import tree_leaves, tree_map


def policy_shardings(mesh: EnvMesh, params: Any,
                     min_shard_params: int = 1 << 20) -> Any:
    """A tree parallel to ``params``: None where a leaf is replicated,
    else the dim that would be partitioned over the mesh (the largest
    one the shard count divides).  Below ``min_shard_params`` parameters,
    or on one shard, everything is replicated."""
    extent = mesh.num_shards
    n_params = sum(x.numel() for x in tree_leaves(params))
    shard = extent > 1 and n_params >= min_shard_params

    def one(leaf: torch.Tensor) -> int | None:
        if not shard or leaf.ndim == 0:
            return None
        for i in sorted(range(leaf.ndim), key=lambda i: -leaf.shape[i]):
            if leaf.shape[i] % extent == 0 and leaf.shape[i] >= extent:
                return i
        return None

    return tree_map(one, params)


def disaggregated_env_mesh(num_shards: int | None = None,
                           learner_process: int | None = None,
                           device: torch.device | str | None = None
                           ) -> EnvMesh:
    """The env mesh over every process of the job but the learner's
    (default the last), the actor/learner split.  Every process calls
    it; the learner gets the mesh it holds no shard of."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if learner_process is None:
        learner_process = world - 1
    ranks = tuple(r for r in range(world) if r != learner_process)
    if not ranks:
        raise ValueError("no env process left outside the learner")
    return make_env_mesh(num_shards, device, ranks)


def host_broadcast(tree: Any, source_process: int) -> Any:
    """``tree`` of ``source_process`` on every process of the job, as CPU
    tensors: its structure (a pickle) in one broadcast, then every leaf's
    bytes in one more.  Other processes may pass None.  The
    disaggregated trainer's rollout and params hand-off; a driver call,
    never inside the engine.  Over nccl the bytes cross on the card."""
    import torch.distributed as dist

    is_src = dist.get_rank() == source_process
    if is_src:
        leaves = [x.detach().cpu().contiguous() for x in tree_leaves(tree)]
        skeleton = tree_map(lambda x: _Leaf(), tree)
        meta = [pickle.dumps((skeleton, [(x.dtype, tuple(x.shape))
                                         for x in leaves]))]
    else:
        meta = [None]
    dist.broadcast_object_list(meta, src=source_process)
    skeleton, specs = pickle.loads(meta[0])
    sizes = [int(np.prod(s)) * torch.empty((), dtype=d).element_size()
             for d, s in specs]
    if is_src:
        buf = (torch.cat([x.reshape(-1).view(torch.uint8) for x in leaves])
               if leaves else torch.empty(0, dtype=torch.uint8))
    else:
        buf = torch.empty(sum(sizes), dtype=torch.uint8)
    if dist.get_backend() == "nccl":
        staged = buf.cuda()
        dist.broadcast(staged, src=source_process)
        buf = staged.cpu()
    else:
        dist.broadcast(buf, src=source_process)
    out, at = [], 0
    for (dtype, shape), size in zip(specs, sizes):
        out.append(buf[at:at + size].clone().view(dtype).reshape(shape))
        at += size
    it = iter(out)
    return tree_map(lambda _: next(it), skeleton,
                    is_leaf=lambda x: isinstance(x, _Leaf))


class _Leaf:
    """A leaf's place in a pickled tree skeleton."""


__all__ = ["disaggregated_env_mesh", "host_broadcast", "policy_shardings"]
