"""Rule-based sharding (``repro/distributed/sharding.py``): the plan of
the model-parallel steps, policy placement and the actor/learner
hand-off.

**The plan.**  Models name their activations' dims with *logical* axes
(``batch``, ``heads``, ``vocab``, ...); parameters get logical axes from
their path (``_PARAM_TABLE``).  A ``RuleSet`` maps logical names to mesh
axes, and ``resolve`` turns a shape and its logical names into a spec:
a tuple with one entry per dim, each ``None``, a mesh axis name, or a
tuple of names (``repro``'s ``PartitionSpec``, entry for entry).  A
logical axis whose size the mapped mesh extent does not divide falls
back to replication for that dim, and a mesh axis serves at most one
dim, so one rule set serves every arch.  Every planning function takes
a mesh's *shape*, axis names to extents in mesh order (a dict, or a
``DeviceMesh``, whose shape is read), the counterpart of ``repro``'s
``AbstractMesh``: a (16, 16) plan needs no 256 processes.
``placements`` turns a spec into DTensor placements on a real
``torch.distributed.device_mesh.DeviceMesh``, ``Replicate()`` where
``resolve`` fell back; ``make_shard_fn`` is ``repro``'s
``with_sharding_constraint`` as ``DTensor.redistribute``.

**Policies.**  ``policy_shardings`` is the JAX package's Seed-RL
placement rule as a plan: a policy smaller than ``min_shard_params`` is
replicated on every shard; a larger one over a mesh of several shards
puts each leaf's largest divisible dim on the mesh (FSDP over the env
mesh).  ``place_policy`` places it: across processes each sharded leaf
becomes the process's contiguous slice (the rows of its D/P shards),
``gather_policy`` makes the leaves whole again in one ``EnvMesh.gather``
(counted as ``"policy"`` on ``EnvMesh.log``; over gloo a CUDA tensor is
staged through the host) and ``take_rows`` cuts a whole tree, such as a
gradient, to the slices.  In solo every shard shares one device, so
nothing is cut and nothing is gathered.  ``rl/ppo.py::train_device``,
``train_disaggregated``'s env processes and
``rl/policy_lm.py::LMPolicy.place_params`` place their policies so.
``disaggregated_env_mesh`` and ``host_broadcast`` are
``train_disaggregated``'s env mesh and hand-off.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.core.engine import EnvMesh, make_env_mesh
from repro_torch.models.common import no_shard
from repro_torch.utils.tree import tree_leaves, tree_map, tree_map_with_path

Axes = tuple[str, ...] | str | None
Spec = tuple[Axes, ...]


@dataclasses.dataclass(frozen=True)
class RuleSet:
    rules: dict[str, Axes]
    name: str = "baseline"

    def get(self, logical: str | None) -> Axes:
        if logical is None:
            return None
        return self.rules.get(logical)

    def replace(self, **kw: Axes) -> "RuleSet":
        new = dict(self.rules)
        new.update(kw)
        return RuleSet(new, name=self.name + "+")


FSDP = ("pod", "data")

# weights: FSDP over (pod, data) on the d_model-like dim, tensor
# parallel over model on heads / mlp / vocab / expert dims; activations:
# batch over (pod, data), heads / mlp / vocab over model; the KV cache's
# positions over model
BASELINE_RULES = RuleSet({
    # activations
    "batch": FSDP,
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "capacity": "model",   # repro's rule; none of its shard points names it
    "kv_seq": "model",
    "layers": None,
    "enc_seq": None,
    # weights
    "w_fsdp": FSDP,
    "w_model": "model",
    "w_expert": "model",
})

# sequence parallel: the residual stream sharded over model between
# the attention and MLP blocks
SP_RULES = dataclasses.replace(BASELINE_RULES.replace(seq="model"),
                               name="seqpar")

# data and sequence parallel only, for small models: no tensor
# parallelism, weights FSDP over data, the model axis shards the
# sequence
DP_RULES = RuleSet({
    "batch": FSDP,
    "seq": "model",
    "embed": None,
    "heads": None,
    "kv_heads": None,
    "mlp": None,
    "vocab": None,
    "expert": None,
    "kv_seq": "model",
    "layers": None,
    "enc_seq": None,
    "w_fsdp": ("data",),
    "w_model": None,
    "w_expert": None,
}, name="dp")

# ZeRO-1: parameters replicated, only the optimizer state sharded over
# data (``opt_state_shardings``)
ZERO1_RULES = RuleSet({
    "batch": FSDP,
    "seq": None,
    "embed": None,
    "heads": None,
    "kv_heads": None,
    "mlp": None,
    "vocab": None,
    "expert": None,
    "capacity": None,
    "kv_seq": "model",
    "layers": None,
    "enc_seq": None,
    "w_fsdp": None,
    "w_model": None,
    "w_expert": None,
}, name="zero1")

# the env pool's state: every leaf's dim 0 over the pool's mesh axis
ENVPOOL_RULES = RuleSet({"env_shard": "env"}, name="envpool")


def mesh_shape(mesh: Any) -> dict[str, int]:
    """Axis name -> extent, in mesh order, of a dict or a
    ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def _mesh_extent(shape: dict[str, int], axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(shape[a] for a in axes)


def resolve(mesh: Any, shape: tuple[int, ...],
            logical: tuple[str | None, ...], rules: RuleSet) -> Spec:
    """Logical names -> a spec, with the divisibility fallback: per dim,
    the rule's mesh axes that the mesh has, that no earlier dim took,
    and whose running extent divides the dim's size."""
    ms = mesh_shape(mesh)
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} vs logical axes {logical}")
    used: set[str] = set()
    spec: list[Axes] = []
    for size, name in zip(shape, logical):
        axes = rules.get(name)
        if axes is None:
            spec.append(None)
            continue
        keep: list[str] = []
        extent = 1
        for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
            if a not in ms or a in used or size % (extent * ms[a]):
                continue
            keep.append(a)
            extent *= ms[a]
        if not keep:
            spec.append(None)
        else:
            used.update(keep)
            spec.append(tuple(keep) if len(keep) > 1 else keep[0])
    return tuple(spec)


def placements(spec: Spec, mesh: Any) -> list:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: for
    each mesh dim, ``Shard(d)`` for the tensor dim ``d`` whose entry
    names it, else ``Replicate()``.  A dim over several mesh axes takes
    them in mesh order, as GSPMD does.  A mesh dim of extent 1 is
    ``Replicate()`` whatever the spec says: the same layout, and DTensor
    refuses some views of a dim sharded over one device (a batch of 1
    flattened into the rows of a matmul)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    extent = mesh_shape(mesh)
    out = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            if extent[names[i]] > 1:
                out[i] = Shard(d)
    return out


def make_shard_fn(mesh: Any, rules: RuleSet
                  ) -> Callable[[torch.Tensor, tuple], torch.Tensor]:
    """``shard(x, logical_names)``: ``x`` redistributed to the placements
    that ``resolve`` gives it on the ``DeviceMesh`` ``mesh``
    (``repro``'s ``with_sharding_constraint``); trailing dims without a
    name are replicated.  Without a mesh, ``no_shard``.  A tensor that
    is not a DTensor passes through: it lies on one device.

    Under autograd, on a mesh of several devices, ``x`` is redistributed
    even when it is laid out already: ``Redistribute``'s backward lays
    the gradient out as ``x`` is, as the transpose of
    ``with_sharding_constraint`` constrains the cotangent.  Left to
    DTensor, a gradient keeps the layout its producer gave it (a
    ``Partial`` sum over ``model`` out of a row-parallel product), and
    the products of the backward then gather weights where the
    forward's shard point had reduced the activation."""
    if mesh is None:
        return no_shard
    from torch.distributed.tensor import DTensor

    def shard(x: torch.Tensor, names: tuple[str | None, ...]
              ) -> torch.Tensor:
        if not isinstance(x, DTensor):
            return x
        names = tuple(names) + (None,) * (x.ndim - len(names))
        want = tuple(placements(resolve(mesh, x.shape, names, rules), mesh))
        if tuple(x.placements) == want and not (
                torch.is_grad_enabled() and x.requires_grad
                and mesh.size() > 1):
            return x
        return x.redistribute(mesh, want)

    shard.mesh = mesh
    shard.rules = rules
    return shard


# --------------------------------------------------------------------- #
# parameter logical axes (path-driven)
# --------------------------------------------------------------------- #
_PARAM_TABLE: list[tuple[tuple[str, ...], tuple[str | None, ...]]] = [
    # (path suffix, logical axes without the stacked-layer dim)
    (("embed",), ("vocab", "w_fsdp")),
    (("dec_embed",), ("vocab", "w_fsdp")),
    (("lm_head",), ("w_fsdp", "vocab")),
    (("dec_pos",), ("w_fsdp", None)),
    (("attn", "wq"), ("w_fsdp", "w_model")),
    (("attn", "wk"), ("w_fsdp", "w_model")),
    (("attn", "wv"), ("w_fsdp", "w_model")),
    (("attn", "wo"), ("w_model", "w_fsdp")),
    (("self_attn", "wq"), ("w_fsdp", "w_model")),
    (("self_attn", "wk"), ("w_fsdp", "w_model")),
    (("self_attn", "wv"), ("w_fsdp", "w_model")),
    (("self_attn", "wo"), ("w_model", "w_fsdp")),
    (("cross_attn", "wq"), ("w_fsdp", "w_model")),
    (("cross_attn", "wk"), ("w_fsdp", "w_model")),
    (("cross_attn", "wv"), ("w_fsdp", "w_model")),
    (("cross_attn", "wo"), ("w_model", "w_fsdp")),
    (("mlp", "wi"), ("w_fsdp", "w_model")),
    (("mlp", "wg"), ("w_fsdp", "w_model")),
    (("mlp", "wo"), ("w_model", "w_fsdp")),
    (("moe", "router"), ("w_fsdp", None)),
    (("moe", "wi"), ("w_expert", "w_fsdp", None)),
    (("moe", "wg"), ("w_expert", "w_fsdp", None)),
    (("moe", "wo"), ("w_expert", None, "w_fsdp")),
    (("ssm", "in_proj"), ("w_fsdp", "w_model")),
    (("ssm", "out_proj"), ("w_model", "w_fsdp")),
    (("ssm", "conv"), (None, "w_model")),
    (("ssm", "A_log"), ("w_model", None)),
    (("ssm", "B_proj"), ("w_model", None)),
    (("ssm", "C_proj"), ("w_model", None)),
    (("ssm", "dt_proj"), ("w_model", None)),
    (("ssm", "D"), ("w_model",)),
    (("mlstm", "wq"), ("w_fsdp", "w_model")),
    (("mlstm", "wk"), ("w_fsdp", "w_model")),
    (("mlstm", "wv"), ("w_fsdp", "w_model")),
    (("mlstm", "wog"), ("w_fsdp", "w_model")),
    (("mlstm", "wo"), ("w_model", "w_fsdp")),
    (("slstm", "up"), ("w_fsdp", "w_model")),
    (("slstm", "down"), ("w_model", "w_fsdp")),
]


def _keys(path: str) -> tuple[str, ...]:
    return tuple(path.split(".")) if path else ()


def _logical(path: str, leaf: torch.Tensor) -> tuple[str | None, ...]:
    keys = _keys(path)
    for suffix, axes in _PARAM_TABLE:
        if keys[-len(suffix):] != suffix:
            continue
        if leaf.ndim == len(axes) + 1:      # stacked layers
            return ("layers",) + axes
        if leaf.ndim == len(axes):
            return axes
    # norms, gates, biases, small vectors: replicated
    return (None,) * leaf.ndim


def param_logical_axes(params: Any) -> Any:
    """A tree parallel to ``params`` of each leaf's logical axes; a
    stacked leaf (one dim more than its table row) gets ``layers``
    first."""
    return tree_map_with_path(_logical, params)


def param_shardings(mesh: Any, params_shape: Any, rules: RuleSet) -> Any:
    """The spec of every leaf of a params (or optimizer-state) tree."""
    def one(path: str, leaf: torch.Tensor) -> Spec:
        if leaf.ndim == 0:
            return ()
        return resolve(mesh, tuple(leaf.shape), _logical(path, leaf), rules)

    return tree_map_with_path(one, params_shape)


def opt_state_shardings(mesh: Any, opt_shape: Any) -> Any:
    """ZeRO-1: every optimizer-state leaf sharded over ``data`` on its
    largest dim that the extent divides (parameters stay
    replicated)."""
    data = mesh_shape(mesh).get("data", 1)

    def one(leaf: torch.Tensor) -> Spec:
        if leaf.ndim == 0:
            return ()
        for i in sorted(range(leaf.ndim), key=lambda i: -leaf.shape[i]):
            if leaf.shape[i] % data == 0 and leaf.shape[i] >= data:
                spec: list[Axes] = [None] * leaf.ndim
                spec[i] = "data"
                return tuple(spec)
        return ()

    return tree_map(one, opt_shape)


def tree_shardings_like(mesh: Any, tree_shape: Any,
                        logical_fn: Callable[[str, torch.Tensor], tuple]
                        ) -> Any:
    """Specs from ``logical_fn(path, leaf)`` under ``BASELINE_RULES``."""
    return tree_map_with_path(
        lambda path, leaf: resolve(mesh, tuple(leaf.shape),
                                   tuple(logical_fn(path, leaf)),
                                   BASELINE_RULES), tree_shape)


def replicated(mesh: Any) -> Spec:
    """The spec of a leaf on every device whole."""
    return ()


def pool_state_shardings(mesh: Any, state_shape: Any,
                         rules: RuleSet = ENVPOOL_RULES) -> Any:
    """Specs of a stacked-by-shard pool state: dim 0 over the env axis,
    the rest replicated."""
    def one(leaf: torch.Tensor) -> Spec:
        if leaf.ndim == 0:
            return ()
        names = ("env_shard",) + (None,) * (leaf.ndim - 1)
        return resolve(mesh, tuple(leaf.shape), names, rules)

    return tree_map(one, state_shape)


def bytes_per_device(tree_shape: Any, shardings: Any, mesh: Any) -> int:
    """The bytes one device holds of a tree laid out by ``shardings``:
    each leaf's bytes over the product of its spec's extents."""
    ms = mesh_shape(mesh)
    sizes: list[int] = []
    tree_map(lambda leaf, spec: sizes.append(
        leaf.numel() * leaf.element_size()
        // math.prod(_mesh_extent(ms, a) for a in spec)),
        tree_shape, shardings)
    return sum(sizes)


def place(tree: Any, shardings: Any, mesh: Any) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` laid out by
    its spec: a DTensor is redistributed (a gradient's ``Partial`` sums
    reduced, ZeRO-1's sharded update gathered back onto replicated
    parameters), a plain tensor distributed.  Each rank keeps its own
    shard of the full leaf it holds (every rank holds the same full
    tree: the same seed, or the same file), so a plain leaf moves no
    data between ranks."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x: torch.Tensor, spec: Spec) -> torch.Tensor:
        want = tuple(placements(spec, mesh))
        if isinstance(x, DTensor):
            return x if tuple(x.placements) == want else x.redistribute(
                mesh, want)
        return distribute_tensor(x, mesh, want, src_data_rank=None)

    return tree_map(one, tree, shardings)


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


def _dims(plan: Any) -> list[int | None]:
    """A plan's entries in tree order, None included."""
    return tree_leaves(plan, is_leaf=lambda v: True)


def cuts(mesh: EnvMesh | None, plan: Any) -> bool:
    """Whether ``plan`` cuts any leaf across ``mesh``'s processes: it
    shards one and the mesh spans several processes.  Never without a
    mesh."""
    return (mesh is not None and mesh.is_multiprocess
            and any(d is not None for d in _dims(plan)))


def take_rows(mesh: EnvMesh | None, tree: Any, plan: Any) -> Any:
    """``tree``, whole leaves like the policy's (params, a gradient), cut
    to this process's part by ``plan``: each sharded leaf's contiguous
    slice of its dim, the rows of the process's D/P shards, as a tensor
    of its own (the whole leaf can be freed); the other leaves as they
    are.  Unchanged when the plan cuts nothing (``cuts``)."""
    if not cuts(mesh, plan):
        return tree
    p, i = len(mesh.ranks), mesh.index

    def one(x: torch.Tensor, dim: int | None) -> torch.Tensor:
        if dim is None:
            return x
        n = x.shape[dim] // p
        return x.narrow(dim, i * n, n).clone(
            memory_format=torch.contiguous_format)

    return tree_map(one, tree, plan)


def place_policy(mesh: EnvMesh, params: Any,
                 min_shard_params: int = 1 << 20) -> tuple[Any, Any]:
    """``(local, plan)``: ``policy_shardings``' plan of ``params`` over
    ``mesh`` and the part of ``params`` this process holds by it
    (``take_rows``).  Every process of the mesh holds the same whole
    ``params`` (the same seed, or the same broadcast), so placing moves
    no data.  In solo, or below ``min_shard_params``, ``local`` is
    ``params``."""
    plan = policy_shardings(mesh, params, min_shard_params)
    return take_rows(mesh, params, plan), plan


_ALIGN = 16     # bytes: each leaf's segment of a packed gather


def gather_policy(mesh: EnvMesh | None, local: Any, plan: Any) -> Any:
    """The whole policy from every process's ``local`` part: the sharded
    leaves' bytes packed into one buffer (each leaf's segment padded to
    16 bytes), one ``mesh.gather(..., "policy")`` of it, and each leaf
    concatenated along its dim in process order; the other leaves as
    they are.  Every process of the mesh calls it.  ``local`` itself
    when the plan cuts nothing: no collective, nothing logged."""
    if not cuts(mesh, plan):
        return local
    parts = [(x, d) for x, d in zip(tree_leaves(local), _dims(plan))
             if d is not None]
    sizes = [x.numel() * x.element_size() for x, _ in parts]
    padded = [-(-n // _ALIGN) * _ALIGN for n in sizes]
    buf = torch.zeros(sum(padded), dtype=torch.uint8,
                      device=parts[0][0].device)
    at = 0
    for (x, _), n, step in zip(parts, sizes, padded):
        buf[at:at + n] = x.contiguous().reshape(-1).view(torch.uint8)
        at += step
    rows = mesh.gather(buf, "policy").reshape(len(mesh.ranks), -1)
    whole, at = [], 0
    for (x, dim), n, step in zip(parts, sizes, padded):
        whole.append(torch.cat([r[at:at + n].view(x.dtype).reshape(x.shape)
                                for r in rows], dim=dim))
        at += step
    it = iter(whole)
    return tree_map(lambda x, dim: x if dim is None else next(it),
                    local, plan)


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


__all__ = [
    "BASELINE_RULES", "DP_RULES", "ENVPOOL_RULES", "FSDP", "RuleSet",
    "SP_RULES", "ZERO1_RULES", "bytes_per_device", "cuts",
    "disaggregated_env_mesh", "gather_policy", "host_broadcast",
    "make_shard_fn", "mesh_shape", "place_policy", "take_rows",
    "no_shard", "opt_state_shardings", "param_logical_axes",
    "param_shardings", "placements", "policy_shardings",
    "place", "pool_state_shardings", "replicated", "resolve",
    "tree_shardings_like",
]
