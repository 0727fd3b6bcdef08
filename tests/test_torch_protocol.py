"""The port's front-end protocol (``core/protocol.py``: ``EnvPool``,
``bind``), dm_env facade (``core/dm_api.py``), ``DeviceEnvPool.xla()``
and checkpoint store (``checkpoint/store.py``) against ``repro``'s, run
live in the same process.  Discrete fields bitwise; Ant's floats within
1e-4 (tests/test_torch_pool.py says why), CartPole's within 1e-5.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.dm_api as jdm  # noqa: E402
import repro.core.registry as jax_registry  # noqa: E402
import repro.core.protocol as jproto  # noqa: E402
import repro.obs.telemetry as jt  # noqa: E402
from repro.checkpoint.store import CheckpointStore as JaxStore  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.core import dm_api, protocol  # noqa: E402
from repro_torch.core.specs import TimeStep  # noqa: E402
from repro_torch.obs import telemetry as tt  # noqa: E402

from _torch_pair import (  # noqa: E402
    actions,
    assert_stats_equal,
    compare,
    make_pair,
)


def test_device_pool_is_a_functional_env_pool():
    pool = repro_torch.make("CartPole-v1", 4, device="cpu")
    assert isinstance(pool, protocol.EnvPool)
    assert protocol.is_functional(pool)
    assert not protocol.is_functional(object())


@pytest.mark.parametrize("task,m", [("Ant-v3", 4), ("CartPole-v1", None)])
def test_bind_matches_repro(task, m):
    atol = 1e-4 if task.startswith("Ant") else 1e-5
    jp, tp = make_pair(task, 8, m, max_episode_steps=4)
    jh = jproto.bind(jp, seed=3)
    th = protocol.bind(tp, seed=3)
    assert th.functional and th.state is None
    assert (th.num_envs, th.batch_size) == (jh.num_envs, jh.batch_size)
    jts, tts = jh.reset(), th.reset()
    for t in range(9):
        compare(f"bind {t}", jts, tts, atol)
        a = actions(tp.spec, jts.env_id, t)
        if t % 2:
            jh.send(jnp.asarray(a), jts.env_id)
            th.send(torch.from_numpy(a), tts.env_id)
            jts, tts = jh.recv(), th.recv()
        else:
            jts = jh.step(jnp.asarray(a), jts.env_id)
            tts = th.step(torch.from_numpy(a), tts.env_id)
    assert_stats_equal(jh.stats(), th.stats(), task)
    th.close()


@pytest.mark.parametrize("gamma", [1.0, 0.99])
def test_dm_env_matches_repro(gamma):
    """Async Ant with 4-step episodes: LAST on done, FIRST on the next
    transition of that env, discounts, a reset block FIRST with no
    reward."""
    jp, tp = make_pair("Ant-v3", 8, 4, max_episode_steps=4)
    jd, td = jdm.DmEnv(jp, gamma=gamma), dm_api.DmEnv(tp, gamma=gamma)
    assert td.action_spec() is tp.spec.act_spec
    assert td.observation_spec() is tp.spec.obs_spec
    with pytest.raises(RuntimeError):
        dm_api.DmEnv(tp).step(None, None)
    jts = jd.reset(jax.random.PRNGKey(5))
    tts = td.reset(repro_torch.random.PRNGKey(5))
    kinds = set()
    for t in range(12):
        for f in ("step_type", "discount"):
            np.testing.assert_array_equal(getattr(tts, f).numpy(),
                                          np.asarray(getattr(jts, f)),
                                          err_msg=f"{t} {f}")
        np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(tts.observation.obs.numpy(),
                                   np.asarray(jts.observation.obs),
                                   rtol=0, atol=1e-4)
        ids = tts.observation.env_id
        np.testing.assert_array_equal(ids.numpy(),
                                      np.asarray(jts.observation.env_id))
        kinds |= set(tts.step_type.tolist())
        assert torch.equal(tts.first(), tts.step_type == 0)
        assert torch.equal(tts.last(), tts.step_type == 2)
        a = actions(tp.spec, ids, t)
        jts = jd.step(jnp.asarray(a), jts.observation.env_id)
        tts = td.step(torch.from_numpy(a), ids)
    assert kinds == {0, 1, 2}


def test_xla_handle():
    pool = repro_torch.make("Ant-v3", 8, 4, device="cpu")
    handle, recv, send, step = pool.xla(seed=2)
    same = pool.init(repro_torch.random.PRNGKey(2))
    assert torch.equal(handle.env_states.q, same.env_states.q)
    keyed, *_ = pool.xla(key=repro_torch.random.PRNGKey(2))
    assert torch.equal(keyed.rng, handle.rng)
    ps, ts = recv(handle)
    ps = send(ps, torch.zeros(4, 8), ts.env_id)
    ps, ts2 = step(ps, torch.zeros(4, 8), ts.env_id)
    # repro's jitted handle functions give the same blocks
    jp = jax_registry.make("Ant-v3", 8, 4, obs=False)
    jh, jrecv, jsend, jstep = jp.xla(seed=2)
    jps, jts = jrecv(jh)
    jps = jsend(jps, jnp.zeros((4, 8)), jts.env_id)
    jps, jts2 = jstep(jps, jnp.zeros((4, 8)), jts.env_id)
    compare("xla recv", jts, ts, 1e-4)
    compare("xla step", jts2, ts2, 1e-4)


class HostPool:
    """A stateful host engine in the JAX package's calling convention:
    numpy in, a dict out."""

    def __init__(self):
        self.spec = repro_torch.make("CartPole-v1", 2, device="cpu").spec
        self.num_envs, self.batch_size = 4, 2
        self.calls = []
        self.closed = False

    def _out(self, ids):
        m = len(ids)
        return dict(obs=np.zeros((m, 4), np.float32),
                    reward=np.ones(m, np.float32), done=np.zeros(m, bool),
                    terminated=np.zeros(m, bool), truncated=np.zeros(m, bool),
                    env_id=np.asarray(ids, np.int32),
                    episode_return=np.zeros(m, np.float32),
                    episode_length=np.zeros(m, np.int32),
                    step_cost=np.ones(m, np.int32))

    def async_reset(self):
        self.calls.append("async_reset")

    def reset(self):
        self.calls.append("reset")
        return self._out([0, 1, 2, 3])

    def send(self, actions, env_ids):
        self.sent = (actions, env_ids)
        self.calls.append("send")

    def recv(self):
        self.calls.append("recv")
        return self._out([2, 3])

    def step(self, actions, env_ids):
        self.calls.append("step")
        return self._out(env_ids)

    def stats(self):
        return {"recvs": len(self.calls)}

    def close(self):
        self.closed = True


def test_bind_over_a_host_engine():
    pool = HostPool()
    assert isinstance(pool, protocol.EnvPool)
    assert not protocol.is_functional(pool)
    h = protocol.bind(pool)
    ts = h.reset()
    assert isinstance(ts, TimeStep) and ts.env_id.tolist() == [2, 3]
    # the host branch hands actions and ids over as they come (a CUDA
    # tensor included: the pool converts them)
    actions = torch.zeros(2)
    h.send(actions, ts.env_id)
    assert pool.sent[0] is actions and pool.sent[1] is ts.env_id
    assert h.recv().reward.tolist() == [1.0, 1.0]
    assert h.step(torch.zeros(2), np.array([0, 1])).env_id.tolist() == [0, 1]
    assert pool.calls == ["async_reset", "recv", "send", "recv", "step"]
    assert h.stats() == {"recvs": 5} and h.state is None
    h.close()
    assert pool.closed
    already = protocol.to_timestep(ts)
    assert already is ts


def test_checkpoint_store(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    assert store.steps() == [] and store.latest_step() is None
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "opt": (torch.tensor(3, dtype=torch.int32),
                    {"key": repro_torch.random.PRNGKey(7)})}
    store.save(1, tree, {"note": "a"})
    tree2 = {"w": tree["w"] + 1, "opt": tree["opt"]}
    store.save_async(2, tree2)
    store.wait()
    # a crash mid-write leaves only a .tmp directory, which is not a step
    os.makedirs(tmp_path / "step_9.tmp")
    assert store.steps() == [1, 2] and store.latest_step() == 2
    assert store.meta(1)["note"] == "a" and store.meta(2)["n_leaves"] == 3
    got = store.restore(2, tree)
    assert torch.equal(got["w"], tree2["w"])
    assert got["opt"][0].dtype == torch.int32
    assert torch.equal(got["opt"][1]["key"], tree["opt"][1]["key"])
    # the same step again keeps the first write; keep=2 drops the oldest
    store.save(2, tree)
    assert torch.equal(store.restore(2, tree)["w"], tree2["w"])
    store.save(3, tree)
    assert store.steps() == [2, 3]


def test_checkpoint_crosses_packages_with_dataclass_leaves(tmp_path):
    """A ``repro`` tree holding a pytree dataclass (its files named
    ``.field`` as jax prints the path) restores into the port's tree of
    the same structure, and back."""
    rng = np.random.default_rng(0)
    serves = rng.integers(0, 9, 5).astype(np.int32)
    jtele = jt.init_telemetry(5).replace(serves=jnp.asarray(serves))
    jtree = ({"mean": jnp.arange(3.0)}, jtele)
    JaxStore(str(tmp_path)).save(4, jtree)
    like = ({"mean": torch.zeros(3)}, tt.init_telemetry(5, "cpu"))
    got = CheckpointStore(str(tmp_path)).restore(4, like)
    assert got[1].serves.tolist() == serves.tolist()
    assert got[0]["mean"].tolist() == [0.0, 1.0, 2.0]
    got = (got[0], got[1].replace(served=torch.tensor(11, dtype=torch.int32)))
    CheckpointStore(str(tmp_path)).save(5, got)
    back = JaxStore(str(tmp_path)).restore(5, jtree)
    assert int(back[1].served) == 11
    np.testing.assert_array_equal(np.asarray(back[1].serves), serves)
