"""The multi-pod dry run (``repro/launch/dryrun.py``): one (arch x shape x
mesh) cell's sharded step, run once on tensors that hold no data.

``repro`` lowers and compiles the cell's jitted step over 512 forced host
devices and reads XLA's analyses.  Here one process joins a *fake*
process group as rank 0 of 256 (or 512) ranks (``torch.testing``'s
``FakeStore``, backend ``"fake"``: every collective returns at once,
moving nothing), builds ``launch/mesh.py::make_production_mesh`` over
it, and runs the cell's step (``launch/steps.py``) once on ``meta``
tensors: the parameters or train state, the cache of
``Model.cache_specs`` and the inputs of ``Model.input_specs``, each laid
out by its plan, so every tensor a rank would hold has its shard's shape
and no storage.  Nothing computes on any device, so it runs on a
machine without a card.  It records:

* the collectives by kind (``all-gather``, ``all-reduce``, ...): counts
  from ``torch.distributed.tensor.debug.CommDebugMode``, operand bytes
  from a dispatch mode that sums the inputs of each ``_c10d_functional``
  op, as ``repro``'s ``parse_collectives`` sums the HLO's operands.
  They are eager DTensor's (the JSON says so under ``counted_as``): one
  collective for each redistribution as the step meets it, the
  recompute's of a rematerialised layer again in the backward, where
  XLA merges and schedules a compiled step's;
* the FLOPs per rank: ``torch.utils.flop_counter``'s formulas at each
  op's shapes, a DTensor op's scaled to the rank's shard of its output
  (and over the mesh dims its output is a partial sum over); the
  attention kernels' stand-ins count the FLOPs the kernels do;
* the argument bytes per rank, the plan's ``bytes_per_device`` (held
  against the placed shards' own bytes);
* the bytes a rank's step allocates (``live_bytes_mode``): the peak of
  the live bytes of the storages the step creates, the rank's local
  shards, as ``repro`` reads XLA's ``memory_analysis``:
  ``temp_size_in_bytes`` is that peak less the output's new bytes, and
  ``peak_size_in_bytes`` (also ``total_per_device``) the argument bytes
  plus that peak, and ``largest_at_peak`` the largest tensors alive at
  it.  It counts the tensors the eager step allocates, the card's path:
  on meta the attention kernels take their stand-ins
  (``kernels/backend.py``), which allocate what the kernels allocate,
  and flash attention's backward is the card's own (``plain_grads``, in
  its chunks).  Allocator rounding, library workspaces and memory a
  kernel takes without a tensor are not counted.

The roofline takes ``repro``'s formulas with
the card's constants (``launch/mesh.py``: H100 SXM): compute and memory
from ``distributed/analytic.py::cell_cost``, collectives at NVLink's
rate.  The counted FLOPs are the card path's: the flash kernel's visible
pairs in the forward and in a rematerialised layer's recompute, every
score of its plain backward.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k [--multi-pod] [--rules baseline|seqpar|dp|zero1] \\
        [--json out.json] [--microbatches N] \\
        [--override attn_impl=blocked] [--override remat=none|full|dots]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Any

import torch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# ``_c10d_functional`` ops that move no data of their own
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def _kind(op_name: str) -> str:
    """A ``_c10d_functional`` op's name -> ``repro``'s collective kind
    (the op's own name when it has none)."""
    for prefix, kind in (("all_gather", "all-gather"),
                         ("all_reduce", "all-reduce"),
                         ("reduce_scatter", "reduce-scatter"),
                         ("all_to_all", "all-to-all")):
        if op_name.startswith(prefix):
            return kind
    return op_name


def _tensors(tree: Any) -> list[torch.Tensor]:
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _collective_bytes_mode():
    """A dispatch mode that sums, by kind, the bytes of the inputs of
    every ``_c10d_functional`` op it sees (``.bytes``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CollectiveBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes: dict[str, int] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ns, _, name = func.name().partition("::")
            if ns == "_c10d_functional" and not name.startswith(
                    _NOT_COLLECTIVES):
                kind = _kind(name.split(".")[0])
                self.bytes[kind] = self.bytes.get(kind, 0) + sum(
                    t.numel() * t.element_size()
                    for t in _tensors((args, kwargs)))
            return func(*args, **kwargs)

    return CollectiveBytes()


def _local_flops_mode():
    """A dispatch mode that counts FLOPs per rank (``.flops``) with
    ``torch.utils.flop_counter``'s formulas: an op on plain tensors (a
    rank's local work) as it is; an op on DTensors, whose shapes are
    global, scaled by the share of its output the rank holds and divided
    by the extents of the mesh dims its output is a partial sum over (a
    contraction split between them)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    from repro_torch.models.common import is_dtensor

    class LocalFlops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                n = float(formula(*args, **kwargs, out_val=out))
                first = _tensors(out)[:1]
                if first and is_dtensor(first[0]):
                    o = first[0]
                    n *= o.to_local().numel() / max(o.numel(), 1)
                    n /= math.prod(o.device_mesh.size(i) for i, p in
                                   enumerate(o.placements) if p.is_partial())
                self.flops += n
            return out

    return LocalFlops()


def live_bytes_mode():
    """A dispatch mode that follows the storages the ops under it create:
    ``.live``, the bytes of those still alive, ``.peak``, the most
    ``.live`` has been, ``.created(t)``, whether ``t``'s storage is one
    of them, ``.allocations()``, each one made (op, shape, dtype,
    bytes), and ``.largest_at_peak()``, the largest alive at the peak.
    A storage is new when it is none of the op's inputs' and not already
    followed (a view, an in-place op and a collective's wait return one
    that is); it is let go when it dies.  An op on a DTensor returns
    ``NotImplemented``, so DTensor runs it and the mode sees its local
    ops, the shards a rank holds; the ops DTensor's sharding propagation
    runs under a fake mode are left out."""
    import weakref

    from torch._guards import active_fake_mode
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class LiveBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = self.peak = 0
            self._sizes: dict[int, int] = {}
            # (storage key, bytes or None when let go, what made it)
            self._events: list[tuple] = []
            self._peak_at = 0

        def _free(self, key: int) -> None:
            self.live -= self._sizes.pop(key)
            self._events.append((key, None, None))

        def created(self, t: torch.Tensor) -> bool:
            return id(t.untyped_storage()) in self._sizes

        def allocations(self) -> list[tuple[str, tuple, str, int]]:
            return [what + (n,) for _, n, what in self._events
                    if what is not None]

        def largest_at_peak(self, n: int = 5) -> list[dict[str, Any]]:
            alive: dict[int, tuple] = {}
            for key, size, what in self._events[:self._peak_at]:
                if size is None:
                    alive.pop(key, None)
                elif what is None:              # a resize
                    alive[key] = (size,) + alive[key][1:]
                else:
                    alive[key] = (size,) + what
            top = sorted(alive.values(), key=lambda e: -e[0])[:n]
            return [{"bytes": b, "op": op, "shape": list(shape),
                     "dtype": dtype} for b, op, shape, dtype in top]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if active_fake_mode() is not None:
                return out
            inputs = {id(t.untyped_storage())
                      for t in _tensors((args, kwargs))}
            for t in _tensors(out):
                st = t.untyped_storage()
                key, n = id(st), st.nbytes()
                if key in self._sizes:          # a resize grows it
                    self.live += n - self._sizes[key]
                    self._sizes[key] = n
                    self._events.append((key, n, None))
                elif key not in inputs:
                    self._sizes[key] = n
                    self.live += n
                    self._events.append((key, n, (
                        str(func.name()), tuple(t.shape),
                        str(t.dtype).removeprefix("torch."))))
                    weakref.finalize(st, self._free, key)
            if self.live > self.peak:
                self.peak, self._peak_at = self.live, len(self._events)
            return out

    return LiveBytes()


def memory_analysis(live, argument_bytes: int, out: Any) -> dict[str, int]:
    """``repro``'s ``memory_analysis`` keys from a step run under
    ``live_bytes_mode`` on arguments of ``argument_bytes`` a rank that
    returned ``out``: the output's bytes, those of it that are arguments
    (``alias``), the temporaries (the peak of the step's own bytes less
    the output's new bytes) and the rank's peak, ``argument + output +
    temp - alias``, also under ``repro``'s ``total_per_device``."""
    from repro_torch.models.common import is_dtensor
    from repro_torch.utils.tree import tree_leaves

    local = [x.to_local() if is_dtensor(x) else x for x in tree_leaves(out)]
    out_bytes = sum(x.numel() * x.element_size() for x in local)
    alias = sum(x.numel() * x.element_size() for x in local
                if not live.created(x))
    temp = live.peak - (out_bytes - alias)
    peak = argument_bytes + out_bytes + temp - alias
    return {"argument_size_in_bytes": argument_bytes,
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": temp,
            "peak_size_in_bytes": peak,
            "total_per_device": peak}


def _comm_counts(comm) -> dict[str, int]:
    """``CommDebugMode``'s counts by ``repro``'s kinds."""
    out: dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        kind = _kind(str(op).split(".")[-1])
        out[kind] = out.get(kind, 0) + int(n)
    return out


def _local_bytes(tree: Any) -> int:
    from repro_torch.models.common import is_dtensor
    from repro_torch.utils.tree import tree_leaves

    return sum((x.to_local() if is_dtensor(x) else x).numel()
               * x.element_size() for x in tree_leaves(tree))


def _meta_inputs(specs: dict[str, Any]) -> dict[str, torch.Tensor]:
    return {k: torch.empty(shape, dtype=dtype, device="meta")
            for k, (shape, dtype) in specs.items()}


def join_fake_group(world_size: int) -> None:
    """This process as rank 0 of a fake process group of
    ``world_size``: collectives return at once and move nothing.  A
    fake group already up (an earlier cell's) is left first; a real one
    is refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process of its own: "
                               "a process group is already up")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_cell(arch: str, shape_name: str, multi_pod: bool, rules_name: str,
             extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """The dry run of one cell -> ``repro``'s result dict (the keys that
    carry over)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.distributed.analytic import cell_cost
    from repro_torch.distributed.sharding import (
        BASELINE_RULES,
        DP_RULES,
        SP_RULES,
        ZERO1_RULES,
        bytes_per_device,
        param_shardings,
        place,
    )
    from repro_torch.launch.mesh import (
        HBM_BW,
        NVLINK_BW,
        PEAK_FLOPS_BF16,
        PRODUCTION_MESHES,
        make_production_mesh,
    )
    from repro_torch.launch.steps import (
        batch_shardings,
        cache_shardings,
        make_prefill_step,
        make_serve_step,
        make_train_step,
        train_state_shapes,
        train_state_shardings,
    )
    from repro_torch.models.api import SHAPES, Model, cell_supported
    from repro_torch.models.common import model_flops_per_token
    from repro_torch.optim import adamw, constant

    t0 = time.time()
    extra = extra or {}
    cfg = get_config(arch, **extra.get("config_overrides", {}))
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    rules = {"baseline": BASELINE_RULES, "seqpar": SP_RULES,
             "dp": DP_RULES, "zero1": ZERO1_RULES}[rules_name]
    n_dev = math.prod(PRODUCTION_MESHES[bool(multi_pod)][1])
    join_fake_group(n_dev)
    mesh = make_production_mesh(multi_pod=multi_pod)
    model = Model(cfg, "meta")
    specs = model.input_specs(shape)
    batch = _meta_inputs(specs)
    batch_sh = batch_shardings(mesh, specs, rules)

    if shape.kind == "train":
        opt = adamw()
        step_fn = make_train_step(model, opt, constant(3e-4), mesh, rules,
                                  microbatches=extra.get("microbatches", 1))
        state = train_state_shapes(model, opt)
        arg_sh = (train_state_shardings(mesh, state, rules), batch_sh)
        args = (state, batch)
    else:
        params = model.init(torch.Generator())
        params_sh = param_shardings(mesh, params, rules)
        if shape.kind == "prefill":
            step_fn = make_prefill_step(model, shape.seq_len, mesh, rules)
            arg_sh, args = (params_sh, batch_sh), (params, batch)
        else:
            step_fn = make_serve_step(model, mesh, rules)
            cache = model.cache_specs(shape)
            arg_sh = (params_sh, cache_shardings(mesh, cache, rules),
                      batch_sh)
            args = (params, cache, batch)
    placed = tuple(place(a, s, mesh) for a, s in zip(args, arg_sh))
    arg_bytes = sum(bytes_per_device(a, s, mesh)
                    for a, s in zip(args, arg_sh))
    if _local_bytes(placed) != arg_bytes:
        raise AssertionError(f"placed shards hold {_local_bytes(placed)} "
                             f"bytes a rank, the plan {arg_bytes}")
    t_place = time.time() - t0

    live = live_bytes_mode()
    coll_bytes, flops = _collective_bytes_mode(), _local_flops_mode()
    with live, CommDebugMode() as comm, coll_bytes, flops:
        out = step_fn(*placed)
    t_run = time.time() - t0 - t_place
    counts = _comm_counts(comm)
    kinds = sorted(set(COLLECTIVES) | set(counts) | set(coll_bytes.bytes))
    coll: dict[str, Any] = {
        k: {"count": counts.get(k, 0),
            "operand_bytes": coll_bytes.bytes.get(k, 0)} for k in kinds}
    coll["total_operand_bytes"] = sum(coll[k]["operand_bytes"]
                                      for k in kinds)
    coll["total_count"] = sum(coll[k]["count"] for k in kinds)
    coll["counted_as"] = ("eager DTensor: one collective a redistribution "
                          "as the step meets it, a rematerialised layer's "
                          "again in its recompute; a compiled step merges "
                          "and schedules them")

    # roofline terms, seconds, ``repro``'s formulas with the card's
    # constants
    ac = cell_cost(cfg, shape, n_dev)
    compute_s = ac.flops_global / (n_dev * PEAK_FLOPS_BF16)
    memory_s = ac.bytes_per_device / HBM_BW
    collective_s = coll["total_operand_bytes"] / NVLINK_BW
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf_tok = model_flops_per_token(cfg)
    if shape.kind != "train":
        mf_tok = mf_tok / 3.0                              # forward only
    model_flops = mf_tok * tokens
    bound = max(compute_s, memory_s, collective_s)
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "rules": rules_name,
        "status": "ok",
        "devices": n_dev,
        "lower_s": round(t_place, 1),
        "run_s": round(t_run, 1),
        "flops_per_device": flops.flops,
        "memory_analysis": dict(
            memory_analysis(live, arg_bytes, out),
            largest_at_peak=live.largest_at_peak(),
            temp_size_note=("the tensors the eager step allocates on "
                            "meta, the attention kernels' stand-ins "
                            "allocating what the kernels allocate; not "
                            "allocator rounding, library workspaces or "
                            "memory a kernel takes without a tensor")),
        "collectives": coll,
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "compute_s_counted": flops.flops / PEAK_FLOPS_BF16,
            "dominant": dominant,
            "model_flops": model_flops,
            "analytic_flops_global": ac.flops_global,
            "analytic_bytes_per_device": ac.bytes_per_device,
            "counted_flops_global": flops.flops * n_dev,
            "useful_flop_frac": (model_flops / ac.flops_global
                                 if ac.flops_global else 0.0),
            "step_time_bound_s": bound,
            "mfu_bound": (model_flops / (n_dev * PEAK_FLOPS_BF16)
                          / max(bound, 1e-12)),
            "card": "H100 SXM (launch/mesh.py constants)",
        },
        "analytic_details": {k: float(v) for k, v in ac.details.items()},
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="baseline",
                    choices=["baseline", "seqpar", "dp", "zero1"])
    ap.add_argument("--json", default=None, help="write result JSON here")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (e.g. attn_impl=blocked)")
    args = ap.parse_args(argv)

    overrides: dict[str, Any] = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except ValueError:
            pass
        overrides[k] = v
    try:
        res = run_cell(args.arch, args.shape, args.multi_pod, args.rules,
                       extra={"microbatches": args.microbatches,
                              "config_overrides": overrides})
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(res, indent=2, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2, default=str)
    return 0 if res["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
