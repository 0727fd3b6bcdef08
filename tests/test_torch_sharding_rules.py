"""The port's sharding plan (``distributed/sharding.py`` and the plan
half of ``launch/steps.py``) against ``repro``'s, at full width, on the
CPU, with no process group.

For every arch of ``list_archs()`` at its full config, each of
``BASELINE_RULES``, ``SP_RULES``, ``DP_RULES`` and ``ZERO1_RULES``, and
mesh shapes (1,1), (1,2), (2,2), (1,3), (1,4), (16,16) and (2,16,16):

* the spec of every parameter and optimizer-state leaf
  (``train_state_shardings``, its ZeRO-1 branch included) equals
  ``repro``'s;
* ``cache_shardings`` over the family's cache of the ``decode_32k``
  cell, and ``batch_shardings`` over ``input_specs`` of every shape
  cell, equal ``repro``'s;
* ``bytes_per_device`` of the train state and of the cache equal
  ``repro``'s.

The port plans over meta tensors (``train_state_shapes``,
``Model(cfg, "meta").init_cache``) and a mesh's shape; ``repro`` over
``jax.eval_shape`` and an ``AbstractMesh`` of the same shape.  A
``repro`` spec is compared as the tuple of its entries.  Then
``resolve``'s divisibility fallback and no-reuse properties, as
tests/test_sharding.py holds ``repro``'s.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import repro.distributed.sharding as JS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.api import SHAPES as J_SHAPES  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402

import repro_torch.distributed.sharding as TS  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.models import SHAPES, Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    tree_leaves_with_path,
    tree_map,
)

RULES = ("BASELINE_RULES", "SP_RULES", "DP_RULES", "ZERO1_RULES")
MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((1, 3), ("data", "model")),
          ((1, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
DECODE = "decode_32k"


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def j_specs(tree) -> dict:
    """Path -> spec tuple of a ``repro`` tree of NamedShardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {".".join(_key(k) for k in path): tuple(s.spec)
            for path, s in flat}


def t_specs(shapes, plan) -> dict:
    """Path -> spec of the port's plan, keyed by the shape tree's leaf
    paths (the plan's tuples are leaves, not containers)."""
    specs: list = []
    tree_map(lambda leaf, spec: specs.append(spec), shapes, plan)
    return dict(zip((p for p, _ in tree_leaves_with_path(shapes)), specs))


@pytest.fixture(scope="module")
def trees():
    """Per arch: (repro model, repro state and cache shapes, port model,
    port state and cache meta tensors), built once."""
    out = {}
    for arch in list_archs():
        jm = j_build(j_config(arch))
        tm = Model(get_config(arch), "meta")
        shape = SHAPES[DECODE]
        out[arch] = (
            jm, JST.train_state_shapes(jm, j_adamw()),
            jax.eval_shape(lambda jm=jm: jm.init_cache(
                shape.global_batch, shape.seq_len)),
            tm, TST.train_state_shapes(tm, adamw()),
            tm.init_cache(shape.global_batch, shape.seq_len))
    return out


def test_every_arch_has_full_width_meta_shapes(trees):
    """The two packages' full-width train states have the same leaves,
    shapes and dtypes (the plans below are then compared leaf by
    leaf)."""
    assert sorted(trees) == list_archs()
    for arch, (_, jstate, _, _, tstate, _) in trees.items():
        flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
        want = {".".join(_key(k) for k in p): (tuple(x.shape),
                                               np.dtype(x.dtype).name)
                for p, x in flat}
        got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for p, x in tree_leaves_with_path(tstate)}
        assert got == want, arch
        assert all(x.device.type == "meta"
                   for _, x in tree_leaves_with_path(tstate))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])) if isinstance(m, tuple) else str(m))
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", list_archs())
def test_plan_equals_repro(trees, arch, rules, mesh):
    sizes, names = mesh
    jmesh = AbstractMesh(sizes, names)
    tmesh = dict(zip(names, sizes))
    jrules, trules = getattr(JS, rules), getattr(TS, rules)
    jm, jstate, jcache, tm, tstate, tcache = trees[arch]

    # parameters and optimizer state (ZeRO-1's own branch included)
    jplan = JST.train_state_shardings(jmesh, jstate, jrules)
    tplan = TST.train_state_shardings(tmesh, tstate, trules)
    want, got = j_specs(jplan), t_specs(tstate, tplan)
    assert got == want
    if rules == "ZERO1_RULES":     # the parameters stay whole
        assert all(v == (None,) * len(v) for k, v in got.items()
                   if k.startswith("params."))
    assert (TS.bytes_per_device(tstate, tplan, tmesh)
            == JS.bytes_per_device(jstate, jplan, jmesh))

    # the decode cell's cache
    jc = JST.cache_shardings(jmesh, jcache, jrules)
    tc = TST.cache_shardings(tmesh, tcache, trules)
    assert t_specs(tcache, tc) == j_specs(jc)
    assert (TS.bytes_per_device(tcache, tc, tmesh)
            == JS.bytes_per_device(jcache, jc, jmesh))

    # every shape cell's inputs
    for cell in SHAPES:
        jb = JST.batch_shardings(jmesh, jm.input_specs(J_SHAPES[cell]),
                                 jrules)
        tb = TST.batch_shardings(tmesh, tm.input_specs(SHAPES[cell]),
                                 trules)
        assert tb == {k: tuple(v.spec) for k, v in jb.items()}, cell


def test_logical_axes_tree_shardings_like_and_pool_state(trees):
    """``param_logical_axes`` of every arch's full-width parameters,
    ``tree_shardings_like`` of the decode cache by ``cache_logical``,
    ``replicated`` and ``pool_state_shardings`` of stacked-by-shard
    leaves equal ``repro``'s."""
    jmesh, tmesh = AbstractMesh((2, 4), ("data", "model")), {"data": 2,
                                                              "model": 4}
    for arch, (_, jstate, jcache, _, tstate, tcache) in trees.items():
        flat, _ = jax.tree_util.tree_flatten_with_path(
            JS.param_logical_axes(jstate.params),
            is_leaf=lambda x: isinstance(x, tuple))
        want = {".".join(_key(k) for k in p): ax for p, ax in flat}
        got = t_specs(tstate.params, TS.param_logical_axes(tstate.params))
        assert got == want, arch
        jl = JST.cache_logical
        assert t_specs(tcache, TS.tree_shardings_like(
            tmesh, tcache, TST.cache_logical)) == j_specs(
            JS.tree_shardings_like(jmesh, jcache, jl)), arch
    assert TS.replicated(tmesh) == tuple(JS.replicated(jmesh).spec)
    shapes = {"obs": (8, 29), "tick": (4,), "rng": (4, 2), "n": (),
              "odd": (6, 3)}
    jtree = {k: jax.ShapeDtypeStruct(v, np.float32)
             for k, v in shapes.items()}
    ttree = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
    jpool, tpool = AbstractMesh((4,), ("env",)), {"env": 4}
    assert t_specs(ttree, TS.pool_state_shardings(tpool, ttree)) == \
        j_specs(JS.pool_state_shardings(jpool, jtree))


def test_zero1_shards_only_the_optimizer_state(trees):
    """Under ZERO1_RULES on (2, 2) the parameters are whole and the
    moments sharded over data, as ``repro``'s ``train_state_shardings``
    makes them; bytes per device then drop below the whole state's."""
    _, _, _, _, tstate, _ = trees["qwen3-0.6b"]
    mesh = {"data": 2, "model": 2}
    plan = TST.train_state_shardings(mesh, tstate, TS.ZERO1_RULES)
    got = t_specs(tstate, plan)
    assert got["params.layers.attn.wq"] == (None, None, None)
    assert "data" in got["opt.mu.layers.attn.wq"]
    whole = sum(x.numel() * x.element_size()
                for _, x in tree_leaves_with_path(tstate))
    params = sum(x.numel() * x.element_size()
                 for _, x in tree_leaves_with_path(tstate.params))
    assert params < TS.bytes_per_device(tstate, plan, mesh) < whole


@pytest.mark.parametrize("extent", [2, 4, 8, 16])
@pytest.mark.parametrize("size", [1, 2, 3, 6, 8, 12, 48, 100, 4096, 4095])
def test_resolve_divisibility_fallback(size, extent):
    """A dim that the mapped mesh extent does not divide is replicated,
    as ``repro``'s resolve replicates it."""
    mesh = {"data": 1, "model": extent}
    spec = TS.resolve(mesh, (size,), ("mlp",), TS.BASELINE_RULES)
    assert spec == (("model",) if size % extent == 0 else (None,))
    jspec = JS.resolve(AbstractMesh((1, extent), ("data", "model")),
                       (size,), ("mlp",), JS.BASELINE_RULES)
    assert spec == tuple(jspec)


def test_resolve_no_axis_reuse_and_missing_axes():
    """A mesh axis shards at most one dim of a tensor; an axis the mesh
    lacks (``pod`` on one pod) is skipped; a multi-axis rule keeps the
    axes that divide, in order."""
    mesh = {"data": 2, "model": 2}
    assert TS.resolve(mesh, (4, 4), ("mlp", "mlp"),
                      TS.BASELINE_RULES) == ("model", None)
    assert TS.resolve(mesh, (8, 4), ("batch", "heads"),
                      TS.BASELINE_RULES) == ("data", "model")
    pod = {"pod": 2, "data": 2, "model": 2}
    assert TS.resolve(pod, (8,), ("batch",), TS.BASELINE_RULES) == (
        ("pod", "data"),)
    assert TS.resolve(pod, (6,), ("batch",), TS.BASELINE_RULES) == ("pod",)
    with pytest.raises(ValueError):
        TS.resolve(mesh, (4,), ("mlp", "mlp"), TS.BASELINE_RULES)


def test_placements_follow_the_spec():
    """A spec becomes one placement per mesh dim, a dim over several
    axes sharded on each in mesh order (``placements`` reads only the
    mesh's dim names, so a stand-in serves)."""
    from torch.distributed.tensor import Replicate, Shard

    class FakeMesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 2)

    mesh = FakeMesh()
    assert TS.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert TS.placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        TS.placements((("data", "pod"),), mesh)
    assert TS.mesh_shape(mesh) == {"pod": 2, "data": 2, "model": 2}


def test_shard_fn_is_identity_without_a_mesh():
    x = torch.ones(4, 4)
    assert TS.make_shard_fn(None, TS.BASELINE_RULES) is TS.no_shard
    assert TS.no_shard(x, ("batch", "mlp")) is x


def test_policy_shardings_unchanged():
    """The Seed-RL placement rule keeps its plan (rl/policy_lm.py)."""
    from repro_torch.core.engine import EnvMesh

    mesh = EnvMesh(4, "cpu")
    small = {"w": torch.zeros(64, 32), "b": torch.zeros(32)}
    assert TS.policy_shardings(mesh, small) == {"w": None, "b": None}
    big = {"w": torch.zeros(2048, 1024), "b": torch.zeros(3)}
    assert TS.policy_shardings(mesh, big) == {"w": 0, "b": None}
