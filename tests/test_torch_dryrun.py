"""The port's dry run, ``python -m repro_torch.launch.dryrun``, the
counterpart of ``repro``'s (tests/test_system.py's dry-run tests), and
``launch/mesh.py::make_production_mesh``.

One process joins a fake process group as rank 0 of 256 (or 512) ranks
and runs a cell's sharded step once on meta tensors; no device computes,
so it runs here.  Held:

* ``xlstm-125m decode_32k``: status "ok" on 256 devices, the roofline's
  dominant term one of the three;
* ``qwen3-0.6b long_500k``: "skipped" (full attention);
* ``qwen3-0.6b train_4k``: collectives counted, and the argument bytes
  a rank equal to ``bytes_per_device`` of the train state's and the
  batch's plans, computed here on the mesh's shape alone;
* ``--multi-pod``: 512 devices on the 2 x 16 x 16 mesh;
* the per-rank counting on a sharded matmul and a gather of known
  shapes, in this process;
* ``make_production_mesh`` refuses a job of another size than 256 (or
  512 with ``multi_pod``), naming the size it needs;
* the temporary bytes (``live_bytes_mode``): an integer for the train
  and serve cells, a hand-checked count, and the same peak for a small
  train step on meta and on real CPU tensors;
* the kernel path on meta: a smoke train step (blocked, ``full``) on a
  (2, 4) mesh of a fake group of 8 allocates no tensor of the global
  batch's rows and none of the whole vocab (the loss stays on its
  shards), its forward no (S, S) scores; the flash and decode stand-ins
  allocate the kernels' outputs and count their FLOPs (flash's over the
  visible pairs); the train cell's JSON labels its collectives as eager
  DTensor's and lists the largest tensors at its peak;
* the FSDP layout: at qwen3-14b's widths on (2, 4) and (16, 16) fake
  meshes, and at one case a family (MoE, hybrid, xLSTM, Whisper, vlm)
  on (2, 4), no rank allocates a tensor of the global batch's (B, S)
  (nor, for qwen3-14b, its own rows at the whole ``d_ff``): each weight
  is gathered over its FSDP dims at its use (``models/common.py::
  weight``, held on its own: no collective without an FSDP dim, one
  all-gather of the compute dtype with one, and its gradient back in
  the parameter's placement through one reduce-scatter), and a shard
  point lays out the gradient as it lays out the value.

The four cells run at once, one subprocess each, with one OpenMP thread.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1")
CELLS = {
    "xlstm": ["--arch", "xlstm-125m", "--shape", "decode_32k"],
    "skip": ["--arch", "qwen3-0.6b", "--shape", "long_500k"],
    "train": ["--arch", "qwen3-0.6b", "--shape", "train_4k"],
    "multi_pod": ["--arch", "xlstm-125m", "--shape", "decode_32k",
                  "--multi-pod"],
}


@pytest.fixture(scope="module")
def cells():
    """Every cell's JSON, the dry runs started together."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        env=ENV, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, args in CELLS.items()}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, (name, stderr[-3000:])
            out[name] = json.loads(stdout[stdout.index("{"):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


def test_dryrun_cell_subprocess(cells):
    res = cells["xlstm"]
    assert res["status"] == "ok"
    assert res["devices"] == 256 and res["mesh"] == "16x16"
    assert res["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert res["flops_per_device"] > 0
    assert isinstance(res["memory_analysis"]["temp_size_in_bytes"], int)


def test_dryrun_skip_rule(cells):
    assert cells["skip"]["status"] == "skipped"
    assert "sub-quadratic" in cells["skip"]["reason"]


def test_dryrun_train_cell_counts_collectives_and_plan_bytes(cells):
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (
        BASELINE_RULES,
        bytes_per_device,
    )
    from repro_torch.launch.steps import (
        batch_shardings,
        train_state_shapes,
        train_state_shardings,
    )
    from repro_torch.models.api import SHAPES, Model
    from repro_torch.optim import adamw

    res = cells["train"]
    assert res["status"] == "ok" and res["kind"] == "train"
    coll = res["collectives"]
    assert coll["total_count"] > 0 and coll["total_operand_bytes"] > 0
    assert coll["all-gather"]["count"] > 0
    mesh = {"data": 16, "model": 16}
    model = Model(get_config("qwen3-0.6b"), "meta")
    state = train_state_shapes(model, adamw())
    specs = model.input_specs(SHAPES["train_4k"])
    batch = {k: torch.empty(s, dtype=d, device="meta")
             for k, (s, d) in specs.items()}
    want = (bytes_per_device(state, train_state_shardings(
        mesh, state, BASELINE_RULES), mesh)
        + bytes_per_device(batch, batch_shardings(mesh, specs,
                                                  BASELINE_RULES), mesh))
    assert res["memory_analysis"]["argument_size_in_bytes"] == want
    roof = res["roofline"]
    assert roof["step_time_bound_s"] == max(
        roof["compute_s"], roof["memory_s"], roof["collective_s"])
    assert coll["counted_as"].startswith("eager DTensor")
    top = res["memory_analysis"]["largest_at_peak"]
    assert len(top) == 5 and top[0]["bytes"] >= top[-1]["bytes"] > 0
    assert set(top[0]) == {"bytes", "op", "shape", "dtype"}


def test_dryrun_multi_pod(cells):
    res = cells["multi_pod"]
    assert res["status"] == "ok"
    assert res["devices"] == 512 and res["mesh"] == "2x16x16"
    # the same cell on 256 devices holds more a rank
    assert (res["memory_analysis"]["argument_size_in_bytes"]
            < cells["xlstm"]["memory_analysis"]["argument_size_in_bytes"])


def test_dryrun_counts_a_sharded_matmul_per_rank():
    """A (256, 1024) x (1024, 4096) matmul, rows over ``data`` and the
    weight's columns over ``model`` of the 16 x 16 mesh: each rank
    computes its (16, 256) block of the output, 2 * 16 * 1024 * 256
    FLOPs, with no collective; gathering the output's columns is one
    all-gather of that f32 block, 16384 bytes in a rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    assert not dist.is_initialized()
    dryrun.join_fake_group(256)
    try:
        mesh = make_production_mesh()
        x = distribute_tensor(torch.empty(256, 1024, device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(1024, 4096, device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        flops = dryrun._local_flops_mode()
        coll = dryrun._collective_bytes_mode()
        with CommDebugMode() as comm, coll, flops:
            y = x @ w
            assert y.placements == (Shard(0), Shard(1))
            y.redistribute(mesh, [Shard(0), Replicate()])
    finally:
        dist.destroy_process_group()
    assert flops.flops == 2 * 16 * 1024 * 256
    assert dryrun._comm_counts(comm) == {"all-gather": 1}
    assert coll.bytes == {"all-gather": 16 * 256 * 4}


def test_production_mesh_refuses_a_wrong_world_size():
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="job of 256 processes"):
        make_production_mesh(device="cpu")
    dryrun.join_fake_group(8)
    try:
        with pytest.raises(ValueError, match="job of 256 processes.*has 8"):
            make_production_mesh()
    finally:
        dist.destroy_process_group()
    dryrun.join_fake_group(256)
    try:
        with pytest.raises(ValueError, match="job of 512 processes.*has 256"):
            make_production_mesh(multi_pod=True)
        mesh = make_production_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (16, 16)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cell", ["train", "xlstm"])
def test_dryrun_counts_temporary_bytes(cells, cell):
    """The train cell and the serve step (xlstm decode_32k): the
    temporaries an integer, and argument + output + temp - alias the
    rank's peak, as ``repro``'s ``total_per_device``."""
    mem = cells[cell]["memory_analysis"]
    temp = mem["temp_size_in_bytes"]
    assert isinstance(temp, int) and temp >= 0
    assert mem["peak_size_in_bytes"] == mem["total_per_device"] == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"] + temp
        - mem["alias_size_in_bytes"])
    assert mem["peak_size_in_bytes"] > mem["argument_size_in_bytes"]


def test_live_bytes_hand_checked():
    """``y = x * 2; z = y + 1; z.sum()`` on a (1024, 1024) f32 argument:
    y and z (4 MiB each) are alive when the sum's 4 bytes are made, so
    the peak of the step's own bytes is 8 MiB + 4, the temporaries 8 MiB
    and the rank's peak 12 MiB + 4; only the sum outlives the step."""
    from repro_torch.launch import dryrun

    def step(x):
        y = x * 2
        z = y + 1
        return z.sum()

    for device in ("meta", "cpu"):
        x = torch.ones(1024, 1024, device=device)
        live = dryrun.live_bytes_mode()
        with live:
            out = step(x)
        mem = dryrun.memory_analysis(live, 4 << 20, out)
        assert live.peak == (8 << 20) + 4 and live.live == 4, device
        assert mem == {"argument_size_in_bytes": 4 << 20,
                       "output_size_in_bytes": 4,
                       "alias_size_in_bytes": 0,
                       "temp_size_in_bytes": 8 << 20,
                       "peak_size_in_bytes": (12 << 20) + 4,
                       "total_per_device": (12 << 20) + 4}, device


def test_live_bytes_meta_equals_cpu_for_a_sharded_train_step():
    """qwen3-0.6b's smoke config, a train step on a (1, 4) mesh of a fake
    group of 4 (B=4, S=16), once on meta tensors and once on real CPU
    tensors: the same peak of the step's own bytes, exactly, and the
    same report.  (A (2, 2) mesh holds the same; its first DTensor step
    takes three times as long.)"""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (
        BASELINE_RULES,
        bytes_per_device,
        place,
    )
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import (
        batch_shardings,
        init_train_state,
        make_train_step,
        train_state_shardings,
    )
    from repro_torch.models.api import Model
    from repro_torch.optim import adamw, constant

    cfg = get_smoke_config("qwen3-0.6b")
    assert not dist.is_initialized()
    dryrun.join_fake_group(4)
    reports = {}
    try:
        mesh = init_device_mesh("cpu", (1, 4),
                                mesh_dim_names=("data", "model"))
        for device in ("meta", "cpu"):
            model = Model(cfg, device)
            opt = adamw()
            state = init_train_state(model, opt,
                                     torch.Generator().manual_seed(0))
            batch = {k: torch.zeros((4, 16), dtype=torch.int32,
                                    device=device)
                     for k in ("tokens", "labels")}
            sh = (train_state_shardings(mesh, state, BASELINE_RULES),
                  batch_shardings(mesh, batch, BASELINE_RULES))
            args = tuple(place(a, s, mesh) for a, s in zip((state, batch),
                                                           sh))
            step = make_train_step(model, opt, constant(3e-4), mesh,
                                   BASELINE_RULES)
            live = dryrun.live_bytes_mode()
            with live:
                out = step(*args)
            reports[device] = (live.peak, dryrun.memory_analysis(
                live, sum(bytes_per_device(a, s, mesh)
                          for a, s in zip((state, batch), sh)), out))
            del out, args, state
    finally:
        dist.destroy_process_group()
    assert reports["meta"] == reports["cpu"]
    assert reports["meta"][0] > 0


def step_on_fake_mesh(cfg, mesh_shape: tuple[int, int], B: int, S: int,
                      forward_only: bool = False):
    """``cfg``'s train step on a global batch of B sequences of S (the
    inputs of ``Model.input_specs``), on a ``mesh_shape`` (data, model)
    mesh of a fake group, on meta tensors under ``live_bytes_mode``: the
    whole step, or ``train_loss``'s forward alone; returns the
    tracker."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import (
        BASELINE_RULES,
        make_shard_fn,
        place,
    )
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import (
        batch_shardings,
        init_train_state,
        make_train_step,
        train_state_shardings,
    )
    from repro_torch.models.api import Model, ShapeSpec
    from repro_torch.optim import adamw, constant
    from repro_torch.utils.tree import tree_leaves

    assert not dist.is_initialized()
    dryrun.join_fake_group(mesh_shape[0] * mesh_shape[1])
    try:
        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        model, opt = Model(cfg, "meta"), adamw()
        state = init_train_state(model, opt, torch.Generator())
        batch = dryrun._meta_inputs(model.input_specs(
            ShapeSpec("layout", "train", S, B)))
        sh = (train_state_shardings(mesh, state, BASELINE_RULES),
              batch_shardings(mesh, batch, BASELINE_RULES))
        state, batch = (place(a, s, mesh) for a, s in zip((state, batch),
                                                          sh))
        live = dryrun.live_bytes_mode()
        if forward_only:
            from torch.distributed.tensor.experimental import (
                implicit_replication,
            )

            for p in tree_leaves(state.params):
                p.requires_grad_()
            with live, implicit_replication():
                model.train_loss(state.params, batch,
                                 make_shard_fn(mesh, BASELINE_RULES))
        else:
            step = make_train_step(model, opt, constant(3e-4), mesh,
                                   BASELINE_RULES)
            with live:
                step(state, batch)
    finally:
        dist.destroy_process_group()
    return live


def smoke_step_on_fake_mesh(forward_only: bool = False):
    """The smoke qwen3-0.6b (blocked, ``remat="full"``), B=8, S=24, on a
    (2, 4) mesh of a fake group of 8 (``step_on_fake_mesh``)."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("qwen3-0.6b").replace(attn_impl="blocked")
    assert cfg.remat == "full"
    return step_on_fake_mesh(cfg, (2, 4), 8, 24, forward_only)


def global_batch(allocs, cfg, mesh_shape, B: int, S: int) -> list:
    """The allocations whose leading dims are the global batch's (B, S),
    but one named exception that only looks like it: the ``aten::bmm``
    of the flash kernel's plain backward
    (``kernels/flash_attention/ref.py::mha_reference``, whose einsums
    fold a rank's B / data batch rows and its kv heads into one dim),
    (B / data * kv heads a rank, S, hd), which is (B, S, hd) wherever a
    rank holds 2 kv heads on a data axis of 2."""
    data, model = mesh_shape
    kv = cfg.n_kv_heads
    kv_local = kv // model if kv % model == 0 else kv
    flash = ("aten::bmm", (B // data * kv_local, S, cfg.hd))
    return [a for a in allocs if tuple(a[1][:2]) == (B, S)
            and (a[0], tuple(a[1])) != flash]


def test_sharded_step_allocates_no_global_batch_and_no_whole_vocab():
    """Every tensor the step allocates on a rank holds the rank's 4 of
    the 8 rows at most, and at most its 128 of the 512 vocab entries."""
    allocs = smoke_step_on_fake_mesh().allocations()
    assert len(allocs) > 100
    assert [a for a in allocs if tuple(a[1][:2]) == (8, 24)] == []
    assert [a for a in allocs if 512 in a[1]] == []
    assert any(tuple(a[1]) == (4, 24, 128) for a in allocs)   # the logits


def test_blocked_forward_allocates_no_scores():
    """The flash stand-in's forward: no (S, S) tensor, and one output of
    the rank's (4 rows, 1 head, 24, 16) a layer."""
    allocs = smoke_step_on_fake_mesh(forward_only=True).allocations()
    assert [a for a in allocs if tuple(a[1][-2:]) == (24, 24)] == []
    flash = [a for a in allocs if a[0] == "repro_torch::flash_attention"]
    assert [tuple(a[1]) for a in flash] == [(4, 1, 24, 16)] * 2


# qwen3-14b's widths, 1 layer, vocab 4096, blocked, ``remat="full"``:
# (2, 4) with B=8, S=512, and the production mesh with B=256, S=512
ANALOGS = {"2x4": ((2, 4), 8), "16x16": ((16, 16), 256)}


@pytest.mark.parametrize("analog", ANALOGS)
def test_qwen3_14b_analog_allocates_no_global_batch(analog):
    """At widths where DTensor, left to itself, gathered or all-reduced
    the activations of the whole batch beside a weight sharded over
    ``data`` (46 allocations of the global (8, 512) at the (2, 4)
    analog, 14 of (256, 512) at the (16, 16) one), the step
    gathers each weight over its FSDP dims at its use
    (``models/common.py::weight``): no rank allocates a tensor of the
    global batch's (B, S), nor one of its own rows at the whole
    ``d_ff``."""
    from repro_torch.configs import get_config

    mesh_shape, B = ANALOGS[analog]
    S = 512
    cfg = get_config("qwen3-14b").replace(n_layers=1, vocab=4096,
                                          attn_impl="blocked")
    assert cfg.remat == "full"
    allocs = step_on_fake_mesh(cfg, mesh_shape, B, S).allocations()
    assert len(allocs) > 500
    assert global_batch(allocs, cfg, mesh_shape, B, S) == []
    rows = B // mesh_shape[0]
    assert [a for a in allocs if a[1][-1:] == (cfg.d_ff,) and (
        a[1][0] == rows * S or tuple(a[1][:2]) == (rows, S))] == []


# one case a family, on (2, 4): each at a size where, without the
# weight gather, DTensor allocated tensors of the global batch
XLSTM_PAIR = {"slstm_every": 2, "slstm_offset": 1}   # an mLSTM, an sLSTM
FAMILY_LAYOUTS = {
    "granite-moe-3b-a800m": (64, {"n_layers": 1, "attn_impl": "blocked"}),
    "hymba-1.5b": (96, {"n_layers": 1, "attn_impl": "blocked"}),
    "xlstm-125m": (32, {"n_layers": 2}),
    "whisper-large-v3": (64, {"n_layers": 1, "enc_layers": 1,
                              "enc_seq": 64}),
    "qwen2-vl-72b": (64, {"n_layers": 1, "attn_impl": "blocked"}),
}


@pytest.mark.parametrize("arch", FAMILY_LAYOUTS)
def test_family_step_allocates_no_global_batch(arch):
    """The MoE, hybrid, xLSTM, Whisper and vlm train steps at their full
    widths (cut in depth, vocab 4096), B=8 on a (2, 4) mesh: no rank
    allocates a tensor of the global batch's (B, S)."""
    import dataclasses

    from repro_torch.configs import get_config

    S, over = FAMILY_LAYOUTS[arch]
    cfg = get_config(arch)
    if cfg.xlstm is not None:
        over = dict(over, xlstm=dataclasses.replace(cfg.xlstm, **XLSTM_PAIR))
    cfg = cfg.replace(vocab=4096, **over)
    allocs = step_on_fake_mesh(cfg, (2, 4), 8, S).allocations()
    assert len(allocs) > 500
    assert global_batch(allocs, cfg, (2, 4), 8, S) == []


def weight_on_fake_mesh(mesh_shape, placements, rules):
    """A (64, 32) f32 weight on meta, laid out on ``placements`` of a
    ``mesh_shape`` (data, model) mesh of a fake group, with the shard
    function of ``rules`` and the mesh (the caller leaves the group)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import make_shard_fn
    from repro_torch.launch import dryrun

    dryrun.join_fake_group(mesh_shape[0] * mesh_shape[1])
    mesh = init_device_mesh("cpu", mesh_shape,
                            mesh_dim_names=("data", "model"))
    w = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                          placements, src_data_rank=None)
    return w, make_shard_fn(mesh, rules), mesh


@pytest.mark.parametrize("mesh_shape,rules", [((1, 4), "baseline"),
                                              ((2, 4), "zero1")],
                         ids=["1x4-baseline", "2x4-zero1"])
def test_weight_gathers_nothing_without_an_fsdp_dim(mesh_shape, rules):
    """On (1, 4) the plan shards no weight over ``data`` (a dim of
    extent 1 is ``Replicate()``); under ``ZERO1_RULES`` there is no
    ``w_fsdp``, even for a weight split over ``data``: ``weight`` hands
    back the very tensor in its dtype, with no collective."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed.sharding import (
        BASELINE_RULES,
        ZERO1_RULES,
        param_shardings,
        placements,
    )
    from repro_torch.models.common import weight

    rules = {"baseline": BASELINE_RULES, "zero1": ZERO1_RULES}[rules]
    try:
        mesh = dict(zip(("data", "model"), mesh_shape))
        spec = param_shardings(mesh, {"attn": {"wq": torch.empty(64, 32)}},
                               BASELINE_RULES)["attn"]["wq"]
        w, shard, dmesh = weight_on_fake_mesh(mesh_shape, [
            Shard(0), Shard(1)] if rules is ZERO1_RULES else
            [Replicate(), Shard(1)], rules)
        if rules is BASELINE_RULES:
            assert list(w.placements) == placements(spec, dmesh)
        with CommDebugMode() as comm:
            got = weight(w, torch.float32, shard)
        assert got is w
        assert comm.get_total_counts() == 0
    finally:
        dist.destroy_process_group()


def test_weight_gathers_over_data_and_reduce_scatters_its_gradient():
    """On (2, 4) a (w_fsdp, w_model) weight, Shard(0) over ``data`` and
    Shard(1) over ``model``, comes back Replicate over ``data`` with its
    ``model`` shard kept, cast before the gather (one all-gather, of
    bf16); a product with each rank's batch rows gives the weight's
    gradient in the parameter's placement through one reduce-scatter."""
    import torch.distributed as dist
    from torch.distributed.tensor import (
        DTensor,
        Replicate,
        Shard,
        distribute_tensor,
    )
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed.sharding import BASELINE_RULES
    from repro_torch.launch import dryrun
    from repro_torch.models.common import weight

    try:
        w, shard, mesh = weight_on_fake_mesh((2, 4), [Shard(0), Shard(1)],
                                             BASELINE_RULES)
        w.requires_grad_()
        coll = dryrun._collective_bytes_mode()
        with CommDebugMode() as comm, coll:
            got = weight(w, torch.bfloat16, shard)
        assert isinstance(got, DTensor) and got.dtype == torch.bfloat16
        assert got.placements == (Replicate(), Shard(1))
        assert dryrun._comm_counts(comm) == {"all-gather": 1}
        assert coll.bytes == {"all-gather": 32 * 8 * 2}   # a rank's bf16
        x = distribute_tensor(torch.empty(8, 5, 64, device="meta",
                                          dtype=torch.bfloat16),
                              mesh, [Shard(0), Replicate()],
                              src_data_rank=None)
        y = x @ got
        assert y.placements == (Shard(0), Shard(2))
        with CommDebugMode() as comm:
            (g,) = torch.autograd.grad(y, w, torch.ones_like(y))
        assert g.placements == w.placements
        assert dryrun._comm_counts(comm) == {"reduce-scatter": 1}
    finally:
        dist.destroy_process_group()


def test_shard_point_lays_out_the_gradient_too():
    """A shard point constrains the gradient as ``repro``'s
    ``with_sharding_constraint`` does (its transpose is the same
    constraint): the gradient of a (batch, seq, embed) point comes back
    replicated over ``model``, whatever layout the ops after it gave."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.sharding import BASELINE_RULES

    try:
        _, shard, mesh = weight_on_fake_mesh((2, 4), [Shard(0), Shard(1)],
                                             BASELINE_RULES)
        x, c = (distribute_tensor(torch.empty(8, 5, 32, device="meta"),
                                  mesh, p, src_data_rank=None)
                for p in ([Shard(0), Replicate()], [Shard(0), Shard(2)]))
        x.requires_grad_()
        y = shard(x, ("batch", "seq", "embed"))
        (g,) = torch.autograd.grad((y * c).sum(), x)
        assert g.placements == (Shard(0), Replicate())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (False, 0)])
def test_attention_stand_ins_count_the_kernels_flops(causal, window):
    """On meta, ``flash_attention`` (under autograd too) and
    ``decode_attention`` run their stand-ins: the kernels' outputs, and
    FLOPs 4 D a visible (query, key) pair, the pairs counted from the
    mask by brute force (flash: Sq=40 queries end-aligned on Skv=56
    keys)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import dryrun

    B, H, Hkv, Sq, Skv, D = 2, 4, 2, 40, 56, 16
    pos = torch.arange(Sq)[:, None] + (Skv - Sq)
    key = torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= key <= pos
    if window:
        mask &= key > pos - window
    pairs = int(mask.sum())
    q = torch.empty(B, Sq, H, D, device="meta").transpose(1, 2)
    k = torch.empty(B, Hkv, Skv, D, device="meta", requires_grad=True)
    live, flops = dryrun.live_bytes_mode(), dryrun._local_flops_mode()
    with live, flops:
        out = flash_attention(q, k, k, causal=causal, window=window)
    assert out.shape == q.shape and out.stride() == q.stride()
    assert out.grad_fn is not None and out.is_meta
    assert flops.flops == 4 * B * H * D * pairs
    assert live.allocations() == [("repro_torch::flash_attention",
                                   (B, H, Sq, D), "float32",
                                   B * H * Sq * D * 4)]
    with FlopCounterMode(display=False) as counter:
        got = decode_attention(torch.empty(B, H, D, device="meta"), k, k,
                               torch.empty(B, dtype=torch.int32,
                                           device="meta"))
    assert got.shape == (B, H, D) and got.is_meta
    assert counter.get_total_flops() == 4 * B * H * D * Skv
