"""The port's token tasks (``TokenCopy-v0``, ``TokenSkew-v0``,
``TokenRagged-v0``) against ``repro.make`` run live in the same
process: 40 scripted steps with short episodes, so auto-reset, the
per-episode skew draws (``randint`` targets, ``fold_in`` + ``uniform``)
and the context-window gather all run.  Every field is bitwise: the
env is integer arithmetic plus one exact f32 reward sum.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.registry as jax_registry  # noqa: E402
import repro_torch  # noqa: E402

FIELDS = ("obs", "reward", "done", "terminated", "truncated", "env_id",
          "episode_return", "episode_length", "step_cost")


@pytest.mark.parametrize("task,n,m,schedule,kw", [
    ("TokenCopy-v0", 8, None, "fifo", {"ep_len": 6}),
    ("TokenCopy-v0", 8, 4, "fifo", {"ep_len": 6, "vocab": 151936}),
    ("TokenSkew-v0", 8, 4, "sjf", {"ep_len": 9}),
    ("TokenRagged-v0", 8, 4, "sjf", {"ep_len": 8, "ctx_len": 12}),
])
def test_token_streams_match_repro(task, n, m, schedule, kw):
    jp = jax_registry.make(task, num_envs=n, batch_size=m, schedule=schedule,
                           obs=False, **kw)
    tp = repro_torch.make(task, num_envs=n, batch_size=m, schedule=schedule,
                          device="cpu", **kw)
    assert tp.spec.obs_spec.shape == jp.spec.obs_spec.shape
    assert (tp.spec.min_cost, tp.spec.max_cost) == (jp.spec.min_cost,
                                                    jp.spec.max_cost)
    jps, jts = jp.reset(jax.random.PRNGKey(2))
    tps, tts = tp.reset(repro_torch.random.PRNGKey(2))
    jstep = jax.jit(jp.step)
    vocab = tp.spec.num_actions
    returns = []
    for t in range(40):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tts, f).numpy(),
                                          np.asarray(getattr(jts, f)),
                                          err_msg=f"{task} step {t} {f}")
        ids = np.asarray(jts.env_id)
        # copy the revealed token on even lanes, a wrong one on odd lanes
        tok = np.asarray(jts.obs)[:, tp.spec.obs_spec.shape[0] // 2 - 1]
        a = np.where(ids % 2 == 0, tok, (tok + 1) % vocab).astype(np.int32)
        jps, jts = jstep(jps, jnp.asarray(a), jts.env_id)
        tps, tts = tp.step(tps, torch.from_numpy(a), tts.env_id)
        returns.append(float(tts.episode_return.max()))
    assert max(returns) > 0     # finished episodes copied some tokens


def test_token_tasks_are_registered():
    assert {"TokenCopy-v0", "TokenSkew-v0", "TokenRagged-v0"} <= set(
        repro_torch.list_envs())
