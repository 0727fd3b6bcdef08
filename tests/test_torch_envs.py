"""The port's batched envs against the JAX package's: ``MujocoLikeBatch``
and the batched view of ``AtariLike`` (RGB and 84x84 modes) through
``v_step`` with a lane mask, then ``v_observe``.

  * teacher-forced: each step starts both from the JAX package's state,
    carried across field by field (uint32 keys become int64);
  * free-running: both run 25 steps from the same init keys and actions,
    with short episodes so auto-reset draws from the lanes' keys.

XLA's ``cos``/``sin`` differ from torch's by an ulp on a few percent of
inputs, and XLA fuses ``a*b + c`` into fused multiply-adds, so float
state agrees to rounding: Pong's ball velocities and positions within
1e-5, Ant's floats within 1e-5 for one step and 1e-4 over 25.  Pong's
obs and reward are bitwise; every discrete field and key is exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.envs.atari_like import AtariLike as JAtari  # noqa: E402
from repro.envs.mujoco_like import MujocoLike as JMujoco  # noqa: E402
from repro_torch.envs.atari_like import AtariLike, AtariLikeState  # noqa: E402
from repro_torch.envs.batch import VmapBatchEnv  # noqa: E402
from repro_torch.envs.mujoco_like import (  # noqa: E402
    MujocoLike,
    MujocoLikeState,
)

N = 8
TS_FIELDS = ("reward", "done", "terminated", "truncated", "episode_return",
             "episode_length", "step_cost")

ENVS = {
    "ant": (lambda: JMujoco(max_episode_steps=6),
            lambda: MujocoLike(max_episode_steps=6), MujocoLikeState),
    "pong_rgb": (lambda: JAtari(max_episode_steps=6, obs_mode="rgb"),
                 lambda: AtariLike(max_episode_steps=6, obs_mode="rgb"),
                 AtariLikeState),
    "pong_gray84": (lambda: JAtari(max_episode_steps=6),
                    lambda: AtariLike(max_episode_steps=6), AtariLikeState),
}


def to_torch_state(jstate, cls):
    kw = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(getattr(jstate, f.name))
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        kw[f.name] = torch.tensor(a)
    return cls(**kw)


def assert_close(name, got, want, atol):
    got = got.numpy()
    want = np.asarray(want)
    if got.dtype == np.int64 and want.dtype == np.uint32:
        want = want.astype(np.int64)
    if atol and got.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def compare(tag, jstates, jts, jobs, states, ts, obs, state_atol,
            out_atol):
    for f in dataclasses.fields(states):
        assert_close(f"{tag} state.{f.name}", getattr(states, f.name),
                     getattr(jstates, f.name), state_atol)
    for f in TS_FIELDS:
        assert_close(f"{tag} ts.{f}", getattr(ts, f), getattr(jts, f),
                     out_atol)
    assert_close(f"{tag} obs", obs, jobs, out_atol)


def actions(name, rng):
    if name == "ant":
        return rng.uniform(-1.2, 1.2, (N, 8)).astype(np.float32)
    return rng.integers(0, 6, N).astype(np.int32)


@pytest.mark.parametrize("name", sorted(ENVS))
@pytest.mark.parametrize("mode", ["teacher", "free"])
def test_batched_env_matches_jax(name, mode):
    make_j, make_t, cls = ENVS[name]
    jb, tb = make_j().as_batch(), make_t().as_batch()
    jstep, jobserve = jax.jit(jb.v_step), jax.jit(jb.v_observe)
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    js = jb.v_init_state(keys)
    ts_state = tb.v_init_state(torch.from_numpy(
        np.asarray(keys).astype(np.int64)))
    if name == "ant":
        state_atol = out_atol = 1e-5 if mode == "teacher" else 1e-4
    else:
        state_atol, out_atol = 1e-5, 0.0
    rng = np.random.default_rng(9)
    for t in range(25 if mode == "free" else 10):
        a = actions(name, rng)
        do = rng.random(N) < 0.75
        if mode == "teacher":
            ts_state = to_torch_state(js, cls)
        js, jts = jstep(js, jnp.asarray(a), jnp.asarray(do))
        ts_state, tts = tb.v_step(ts_state, torch.from_numpy(a),
                                  torch.from_numpy(do))
        compare(f"{name} {mode} step {t}", js, jts, jobserve(js), ts_state,
                tts, tb.v_observe(ts_state), state_atol, out_atol)
        # finalize leaves obs unset: eager PyTorch has no dead-code
        # elimination, so building it would render every screen twice
        assert tts.obs is None


def test_init_state_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    kt = torch.from_numpy(np.asarray(keys).astype(np.int64))
    for name, (make_j, make_t, _) in ENVS.items():
        js = make_j().as_batch().v_init_state(keys)
        ts = make_t().as_batch().v_init_state(kt)
        # Ant's qd is a normal draw, Pong's velocities go through cos/sin
        atol = 1e-6
        for f in dataclasses.fields(ts):
            assert_close(f"{name} {f.name}", getattr(ts, f.name),
                         getattr(js, f.name), atol)


def test_ant_kernel_path_equals_the_generic_adapter():
    """MujocoLikeBatch (one env_multi_step call) and the generic adapter
    over MujocoLike.substep (a masked loop) run the same ops in the same
    order: bitwise equal on the CPU."""
    env = MujocoLike(max_episode_steps=6)
    keys = torch.from_numpy(np.asarray(
        jax.random.split(jax.random.PRNGKey(2), N)).astype(np.int64))
    native, generic = env.as_batch(), VmapBatchEnv(env)
    assert type(native) is not VmapBatchEnv
    s_native = s_generic = native.v_init_state(keys)
    rng = np.random.default_rng(4)
    for _ in range(8):
        a = torch.from_numpy(actions("ant", rng))
        do = torch.from_numpy(rng.random(N) < 0.75)
        s_native, t_native = native.v_step(s_native, a, do)
        s_generic, t_generic = generic.v_step(s_generic, a, do)
        for f in dataclasses.fields(s_native):
            assert torch.equal(getattr(s_native, f.name),
                               getattr(s_generic, f.name)), f.name
        for f in TS_FIELDS:
            assert torch.equal(getattr(t_native, f), getattr(t_generic, f))
