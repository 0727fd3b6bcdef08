"""The port's remaining transforms (``ObsCast``, ``EpisodicLife``,
``NormalizeObs``) and tasks (``AntNorm-v3``, ``AntSkew-v3``,
``CartPole-v1``, ``MountainCar-v0``, ``Pendulum-v1``) against
``repro``'s, run live in the same process; a ``repro`` PoolState with
telemetry and NormalizeObs moments carried into the port; and
transform-state checkpoints crossing between the packages.

Tolerances: ObsCast and EpisodicLife are bitwise.  NormalizeObs sums
each block in torch's order, not XLA's, so its moments agree to 1e-6
and its normalized values to 1e-3: a value is a difference over a
standard deviation, and Ant's lowest-foot height starts at 0.150 with a
standard deviation of 3.0e-4 over 8 lanes, where a mean a few f32 ulps
(1.5e-8 each) apart moves the value by ~1e-4.
The classic envs' floats agree to 1e-5 (``cos``/``sin`` differ by an ulp
between XLA:CPU and torch:CPU) and their discrete streams bitwise; the
Ant tasks' floats to 1e-4, as Ant-v3's (tests/test_torch_pool.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.transforms as jtf  # noqa: E402
from repro.checkpoint.store import CheckpointStore as JaxStore  # noqa: E402
from repro.core.specs import ArraySpec as JArraySpec  # noqa: E402
from repro.core.specs import EnvSpec as JEnvSpec  # noqa: E402
from repro.core.specs import TimeStep as JTimeStep  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.core import transforms as ttf  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    pool_state_from_numpy,
    pool_state_to_numpy,
)
from repro_torch.core.specs import ArraySpec, EnvSpec, TimeStep  # noqa: E402

from _torch_pair import (  # noqa: E402
    actions,
    assert_stats_equal,
    compare,
    jax_leaves,
    make_pair,
    rollout,
)

NORM_ATOL = 1e-3


def blocks(rng, m, obs):
    """A served block in both packages' TimeStep, from numpy."""
    b = dict(obs=obs, reward=rng.choice([-1.0, 0.0, 0.5, 1.0], m)
             .astype(np.float32), done=rng.random(m) < 0.2,
             terminated=rng.random(m) < 0.1,
             truncated=np.zeros(m, bool), env_id=np.arange(m, dtype=np.int32),
             episode_return=rng.normal(0, 1, m).astype(np.float32),
             episode_length=rng.integers(0, 9, m).astype(np.int32),
             step_cost=np.ones(m, np.int32))
    return (JTimeStep(**{k: jnp.asarray(v) for k, v in b.items()}),
            TimeStep(**{k: torch.from_numpy(v) for k, v in b.items()}))


def specs(shape, dtype, lo, hi):
    act = ((), np.int32, torch.int32)
    j = JEnvSpec("x", JArraySpec(shape, np.dtype(dtype[0]), lo, hi),
                 JArraySpec(act[0], act[1], 0, 1))
    t = EnvSpec("x", ArraySpec(shape, dtype[1], lo, hi),
                ArraySpec(act[0], act[2], 0, 1))
    return j, t


@pytest.mark.parametrize("src,dst,scale,offset", [
    ((np.uint8, torch.uint8), (np.float32, torch.float32), 1 / 255, 0.0),
    ((np.float32, torch.float32), (np.float32, torch.float32), -0.5, 0.25),
    ((np.uint8, torch.uint8), (np.int32, torch.int32), 2.0, -3.0),
])
def test_obs_cast_is_bitwise(src, dst, scale, offset):
    rng = np.random.default_rng(0)
    jspec, tspec = specs((6, 5), src, 0.0, 255.0)
    if src[0] == np.uint8:
        obs = rng.integers(0, 256, (7, 6, 5)).astype(np.uint8)
    else:
        obs = rng.normal(0, 50, (7, 6, 5)).astype(np.float32)
    jts, tts = blocks(rng, 7, obs)
    jt = jtf.ObsCast(dst[0], scale=scale, offset=offset)
    tt = ttf.ObsCast(dst[1], scale=scale, offset=offset)
    _, jout = jt.apply((), jts, jspec)
    _, tout = tt.apply((), tts, tspec)
    assert tout.obs.dtype == dst[1]
    np.testing.assert_array_equal(tout.obs.numpy(), np.asarray(jout.obs))
    jo, to = jt.transform_spec(jspec).obs_spec, tt.transform_spec(tspec)\
        .obs_spec
    assert (to.minimum, to.maximum, to.shape) == (jo.minimum, jo.maximum,
                                                  jo.shape)
    assert to.minimum <= to.maximum


def test_episodic_life_is_bitwise():
    rng = np.random.default_rng(1)
    jspec, tspec = specs((3,), (np.float32, torch.float32), None, None)
    jts, tts = blocks(rng, 32, rng.normal(0, 1, (32, 3)).astype(np.float32))
    for thr in (0.0, 0.75):
        _, jout = jtf.EpisodicLife(thr).apply((), jts, jspec)
        _, tout = ttf.EpisodicLife(thr).apply((), tts, tspec)
        compare(f"threshold {thr}", jout, tout)
    assert bool((tout.done & ~tts.done).any())    # a life was lost


@pytest.mark.parametrize("clip", [10.0, None])
def test_normalize_obs_matches_repro(clip):
    rng = np.random.default_rng(2)
    jspec, tspec = specs((29,), (np.float32, torch.float32), None, None)
    jt, tt = jtf.NormalizeObs(clip=clip), ttf.NormalizeObs(clip=clip)
    js, ts = jt.init(jspec, 8), tt.init(tspec, 8, "cpu")
    for i, m in enumerate((8, 3, 8, 1, 5)):
        obs = (rng.normal(0, 1, (m, 29)) * rng.uniform(0.1, 20, 29)
               + rng.uniform(-5, 5, 29)).astype(np.float32)
        jts, tts = blocks(rng, m, obs)
        js, jout = jt.apply(js, jts, jspec)
        ts, tout = tt.apply(ts, tts, tspec)
        np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs),
                                   rtol=0, atol=NORM_ATOL, err_msg=str(i))
        for k in ("count", "mean", "m2"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    out = tt.transform_spec(tspec).obs_spec
    assert out.dtype == torch.float32
    assert (out.minimum, out.maximum) == ((None, None) if clip is None
                                          else (-clip, clip))


def test_pipeline_of_new_transforms_matches_repro():
    """Pong with a life loss served as an episode end, then stacked and
    cast to [0, 1] floats: bitwise."""
    jp, tp = make_pair(
        "Pong-v5", 4, 2, max_episode_steps=7, obs=False,
        jax_kw={"transforms": [jtf.EpisodicLife(), jtf.FrameStack(2),
                               jtf.ObsCast(np.float32, scale=1 / 255)]},
        torch_kw={"transforms": [ttf.EpisodicLife(), ttf.FrameStack(2),
                                 ttf.ObsCast(torch.float32, scale=1 / 255)]})
    assert tp.spec.obs_spec.dtype == torch.float32
    assert tp.spec.obs_spec.maximum == jp.spec.obs_spec.maximum
    rollout(jp, tp, 14, seed=5)


@pytest.mark.parametrize("task,n,m,schedule,atol", [
    ("AntNorm-v3", 8, None, "fifo", NORM_ATOL),
    ("AntSkew-v3", 8, 4, "sjf", 1e-4),
    ("CartPole-v1", 8, 4, "fifo", 1e-5),
    ("MountainCar-v0", 8, None, "fifo", 1e-5),
    ("Pendulum-v1", 8, 3, "fifo", 1e-5),
])
def test_tasks_match_repro(task, n, m, schedule, atol):
    jp, tp = make_pair(task, n, m, schedule=schedule, max_episode_steps=6)
    for field in ("obs_spec", "act_spec"):
        j, t = getattr(jp.spec, field), getattr(tp.spec, field)
        assert (t.shape, t.minimum, t.maximum) == (j.shape, j.minimum,
                                                   j.maximum)
        assert str(t.dtype).removeprefix("torch.") == np.dtype(j.dtype).name
    assert (tp.spec.min_cost, tp.spec.max_cost) == (jp.spec.min_cost,
                                                    jp.spec.max_cost)
    costs = []
    jps, tps = rollout(jp, tp, 16, seed=3, atol=atol,
                       on_block=lambda t, j, x: costs.append(
                           int(x.step_cost.max())))
    assert_stats_equal(jp.stats(jps), tp.stats(tps), task)
    if task == "AntSkew-v3":
        assert max(costs) > 9      # a heavy episode was served
        heavy = tps.env_states.cost_scale
        np.testing.assert_array_equal(
            heavy.numpy(), np.asarray(jps.env_states.cost_scale))


def test_repro_pool_state_with_telemetry_and_moments_carries_across():
    """``repro``'s AntNorm-v3 PoolState (async, obs=True: counters with
    their shard dims, NormalizeObs moments with theirs) loaded into the
    port continues the same stream and the same counters."""
    jp, tp = make_pair("AntNorm-v3", 8, 4, max_episode_steps=5)
    jps, jts = jp.reset(jax.random.PRNGKey(7))
    jstep = jax.jit(jp.step)
    for t in range(6):
        a = actions(tp.spec, jts.env_id, t)
        jps, jts = jstep(jps, jnp.asarray(a), jts.env_id)
    arrays = jax_leaves(jps)
    assert arrays["tf_state.0.mean"].shape == (1, 29)
    assert arrays["telemetry.wait_hist"].shape == (1, 8)
    tps = pool_state_from_numpy(tp, arrays)
    assert tps.tf_state[0]["mean"].shape == (29,)
    assert tps.telemetry.served.shape == ()
    back = pool_state_to_numpy(tp, tps)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    ids = torch.from_numpy(np.array(jts.env_id))
    for t in range(6, 14):
        a = actions(tp.spec, jts.env_id, t)
        jps, jts = jstep(jps, jnp.asarray(a), jts.env_id)
        tps, tts = tp.step(tps, torch.from_numpy(a), ids)
        compare(f"carried step {t}", jts, tts, NORM_ATOL)
        ids = tts.env_id
    assert_stats_equal(jp.stats(jps), tp.stats(tps))


def test_transform_state_checkpoint_crosses_both_ways(tmp_path):
    """NormalizeObs's moments saved by ``repro`` restore into the port,
    and the port's into ``repro``, in the same file layout."""
    jp, tp = make_pair("AntNorm-v3", 8, None, max_episode_steps=5)
    jps, tps = rollout(jp, tp, 4, seed=1, atol=NORM_ATOL)
    jstore = JaxStore(str(tmp_path / "j"))
    jp.save_transform_state(jstore, 4, jps, {"from": "repro"})
    tstore = CheckpointStore(str(tmp_path / "j"))
    assert tstore.steps() == [4] and tstore.meta(4)["from"] == "repro"
    fresh = tp.init(repro_torch.random.PRNGKey(9))
    got = tp.restore_transform_state(tstore, 4, fresh)
    for k in ("count", "mean", "m2"):
        np.testing.assert_array_equal(got.tf_state[0][k].numpy(),
                                      np.asarray(jps.tf_state[0][k])[0])
    # the port's own moments, saved by the port, restored by repro
    tstore2 = CheckpointStore(str(tmp_path / "t"))
    path = tp.save_transform_state(tstore2, 4, tps)
    assert sorted(p.name for p in (tmp_path / "t" / "step_4").iterdir()) \
        == ["0__count.npy", "0__m2.npy", "0__mean.npy", "meta.json"]
    assert path.endswith("step_4")
    jfresh = jp.init(jax.random.PRNGKey(9))
    jgot = jp.restore_transform_state(JaxStore(str(tmp_path / "t")), 4,
                                      jfresh)
    for k in ("count", "mean", "m2"):
        np.testing.assert_array_equal(np.asarray(jgot.tf_state[0][k])[0],
                                      tps.tf_state[0][k].numpy())
    # a restored pool continues with the restored moments
    _, ts1 = tp.recv(tp.restore_transform_state(tstore2, 4, fresh))
    assert torch.isfinite(ts1.obs).all()
