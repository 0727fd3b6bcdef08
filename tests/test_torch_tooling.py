"""The model zoo's tooling in the port against ``repro``'s, run live in the
same process: ``optim/compression.py`` (codes, scales and the error
buffer bitwise, at tests/test_optim.py's shapes and scales, error
feedback over rounds), ``distributed/analytic.py`` (every number equal
for every arch x ``SHAPES`` cell x device count at the configs' own
``remat``, and the train step's at each ``remat``), its FLOPs
against ``FlopCounterMode``'s count of the port's forward and its
parameter bytes against the port's parameters, and ``repro``'s module
paths: ``core/device_pool.py`` and the three dense config modules."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.distributed import analytic as ja  # noqa: E402
from repro.models.api import SHAPES as J_SHAPES  # noqa: E402
from repro.optim import compression as jc  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    get_config,
    get_smoke_config,
    list_archs,
)
from repro_torch.distributed import analytic as ta  # noqa: E402
from repro_torch.launch.steps import synth_batch  # noqa: E402
from repro_torch.models import ShapeSpec, build_model  # noqa: E402
from repro_torch.models.api import SHAPES  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from repro_torch.optim import compression as tc  # noqa: E402


def assert_same_compression(jq, je, tq, te) -> None:
    """Codes (int8), scales (f32) and error (f32) bitwise."""
    for (jcodes, jscale), (tcodes, tscale) in zip(
            [jq[k] for k in sorted(jq)], [tq[k] for k in sorted(tq)]):
        assert tcodes.dtype == torch.int8 and tscale.dtype == torch.float32
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    for k in je:
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))


@pytest.mark.parametrize("scale", [1e-3, 0.37, 1.0, 41.5, 1e3])
def test_compress_tree_is_repros_bitwise(scale):
    """tests/test_optim.py's roundtrip at its (513,) leaf over its scale
    range, beside a 2-D leaf and one of exactly one block, no error
    buffer: the same codes, scales, error and dequantised values."""
    g = {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (513,)))
         * np.float32(scale),
         "m": np.random.default_rng(1).normal(0, scale, (3, 100)).astype(
             np.float32),
         "b": np.random.default_rng(2).normal(0, scale, 256).astype(
             np.float32)}
    jq, je = jc.compress_tree({k: jnp.asarray(v) for k, v in g.items()},
                              None)
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    tq, te = tc.compress_tree(tg, None)
    assert_same_compression(jq, je, tq, te)
    jd = jc.decompress_tree(jq, {k: jnp.asarray(v) for k, v in g.items()})
    td = tc.decompress_tree(tq, tg)
    for k in g:
        assert td[k].shape == tg[k].shape and td[k].dtype == torch.float32
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))


def test_error_feedback_rounds_are_repros_bitwise():
    """tests/test_optim.py's error-feedback loop (a (257,) leaf, 30
    rounds from ``init_error``): every round's codes, scales, error and
    dequantised sum equal ``repro``'s, and the sum tracks the truth."""
    key = jax.random.PRNGKey(1)
    je = jc.init_error({"w": jnp.zeros(257)})
    te = tc.init_error({"w": torch.zeros(257)})
    assert te["w"].dtype == torch.float32 and not bool(te["w"].any())
    true_sum = np.zeros(257, np.float32)
    deq_sum = torch.zeros(257)
    for i in range(30):
        g = np.asarray(jax.random.normal(jax.random.fold_in(key, i), (257,)))
        true_sum += g
        jq, je = jc.compress_tree({"w": jnp.asarray(g)}, je)
        tq, te = tc.compress_tree({"w": torch.from_numpy(g.copy())}, te)
        assert_same_compression(jq, je, tq, te)
        deq = tc.decompress_tree(tq, {"w": torch.from_numpy(g.copy())})
        np.testing.assert_array_equal(
            deq["w"].numpy(),
            np.asarray(jc.decompress_tree(jq, {"w": jnp.asarray(g)})["w"]))
        deq_sum += deq["w"]
    assert float(np.abs(deq_sum.numpy() - true_sum).max()) < 0.2


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_numbers_equal_repros(arch):
    """``fwd_flops``, ``cell_cost`` (FLOPs, bytes a device and every
    detail), ``param_bytes`` and ``cache_bytes``: the same Python floats
    as ``repro``'s for every ``SHAPES`` cell at 1, 256 and 512 devices."""
    jcfg, tcfg = j_config(arch), get_config(arch)
    assert tcfg.remat == jcfg.remat == "full"
    assert sorted(SHAPES) == sorted(J_SHAPES)
    assert ta.param_bytes(tcfg) == ja.param_bytes(jcfg)
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        assert ta.fwd_flops(tcfg, shape) == ja.fwd_flops(jcfg, jshape)
        assert ta.cache_bytes(tcfg, shape) == ja.cache_bytes(jcfg, jshape)
        for n in (1, 256, 512):
            got, want = ta.cell_cost(tcfg, shape, n), ja.cell_cost(
                jcfg, jshape, n)
            assert got.flops_global == want.flops_global, (name, n)
            assert got.bytes_per_device == want.bytes_per_device, (name, n)
            assert got.details == want.details, (name, n)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_multiplier_is_three_without_remat(remat):
    """A train step is fwd x 3, and one forward more for the recompute at
    ``full`` and ``dots``: ``cell_cost`` equal to ``repro``'s at the same
    ``remat``, for every arch."""
    shape = ShapeSpec("t", "train", 32, 2)
    cfg = get_smoke_config("llama3.2-3b").replace(remat=remat)
    fwd = float(sum(ta.fwd_flops(cfg, shape).values()))
    mult = 3.0 if remat == "none" else 4.0
    assert ta.cell_cost(cfg, shape, 256).flops_global == fwd * mult
    for arch in list_archs():
        got = ta.cell_cost(get_config(arch, remat=remat), SHAPES["train_4k"],
                           256)
        want = ja.cell_cost(dataclasses.replace(j_config(arch), remat=remat),
                            J_SHAPES["train_4k"], 256)
        assert got.flops_global == want.flops_global, arch
        assert got.bytes_per_device == want.bytes_per_device, arch
        assert got.details == want.details, arch


@pytest.mark.parametrize("arch", ["llama3.2-3b", "dbrx-132b", "hymba-1.5b"])
def test_fwd_flops_against_the_counted_forward(arch):
    """tests/test_analytic.py's cross-check with the port's own counter:
    ``FlopCounterMode`` over the port's forward (``train_loss`` at B=2,
    S=32, every layer unrolled) within ``repro``'s 0.5-2.5x of the
    analytic forward FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    shape = ShapeSpec("t", "train", 32, 2)
    batch = synth_batch(model, shape, torch.Generator().manual_seed(1))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model.train_loss(params, batch)
    counted = float(counter.get_total_flops())
    pred = float(sum(ta.fwd_flops(cfg, shape).values()))
    assert 0.5 < counted / pred < 2.5, (arch, counted, pred)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "starcoder2-3b",
                                  "qwen3-14b"])
def test_param_bytes_matches_the_ports_parameters(arch):
    cfg = get_smoke_config(arch)
    real = count_params(build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0))) * 4
    pred = ta.param_bytes(cfg)
    assert abs(pred - real) / real < 0.05, (arch, pred, real)


@pytest.mark.parametrize("module", ["qwen3_14b", "llama3_2_3b",
                                    "starcoder2_3b"])
def test_dense_config_modules_equal_repros(module):
    """``repro_torch.configs.<module>.get_config()`` field by field equal
    to ``repro``'s (the port leaves out ``scan_layers`` and
    ``use_pallas``; dtypes compare by name), and the registry's entry."""
    import importlib

    got = importlib.import_module(f"repro_torch.configs.{module}"
                                  ).get_config()
    want = importlib.import_module(f"repro.configs.{module}").get_config()
    assert get_config(got.name) == got
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(g, torch.dtype):
            assert str(g).removeprefix("torch.") == np.dtype(w).name, f.name
        else:
            assert g == w, f.name


def test_device_pool_module_is_the_mesh_engine():
    """``repro``'s ``core/device_pool.py`` surface: ``DeviceEnvPool`` is
    ``MeshEnvPool``, and ``make_pool`` builds it at one shard."""
    import repro.core.device_pool as jdp

    import repro_torch.core.device_pool as tdp
    from repro_torch.core.engine import MeshEnvPool, PoolState
    from repro_torch.envs.classic import CartPole

    assert sorted(tdp.__all__) == sorted(jdp.__all__)
    assert tdp.DeviceEnvPool is MeshEnvPool and tdp.PoolState is PoolState
    pool = tdp.make_pool(CartPole(), 4, 2, device="cpu")
    assert type(pool) is MeshEnvPool and pool.num_shards == 1
    keys, rng = tdp.derive_env_keys(torch.tensor([0, 3]), 4)
    assert tuple(keys.shape) == (4, 2) and tuple(rng.shape) == (2,)
