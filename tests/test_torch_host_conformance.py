"""The port's host engines against ``repro.make`` with the same engine,
run live in the same process, and against the port's device engine.

Both packages step N = 4 envs from one seed for 10 steps with 5-step
episodes (auto-reset runs), the same actions routed by ``env_id``, every
block sorted by ``env_id``.  Against ``repro``: ids, done, terminated,
truncated, step_cost and episode_length bitwise; Pong obs and reward
bitwise; Ant's obs, reward and return within 1e-4 (XLA's fused
multiply-adds and ``cos`` against torch's, tests/test_torch_pool.py),
CartPole's within 1e-5 (tests/test_torch_protocol.py), AntNorm's
normalized obs within 1e-3 (its block sums run in another order).
Against the port's device engine on the CPU every field is bitwise (one
lane of the batched env is the device engine's per-lane computation),
AntNorm's obs within 1e-3 again (the blocks arrive in another order);
the reset block's ``step_cost`` is 1 in both packages' host engines and
0 in their device engines (``_torch_host.reset_cost_as_device``).
``stats()`` is bitwise across the port's host engine, ``repro``'s same
engine and the port's device engine.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.registry as jax_registry  # noqa: E402
import repro_torch  # noqa: E402

from _torch_host import (  # noqa: E402
    compare_blocks,
    device_rollout,
    host_rollout,
    reset_cost_as_device,
)
from _torch_pair import assert_stats_equal  # noqa: E402

N, STEPS = 4, 10


@pytest.mark.parametrize("engine", ["thread", "forloop"])
@pytest.mark.parametrize("task,atol,obs_atol", [
    ("Ant-v3", 1e-4, 1e-4),
    ("CartPole-v1", 1e-5, 1e-5),
    ("PongClassic-v5", 0.0, 0.0),
    ("AntNorm-v3", 1e-4, 1e-3),
])
def test_host_engine_matches_repro_and_the_device_engine(task, atol,
                                                         obs_atol, engine):
    kw = dict(num_envs=N, engine=engine, num_threads=2, max_episode_steps=5)
    tp = repro_torch.make(task, device="cpu", **kw)
    jp = jax_registry.make(task, **kw)
    try:
        assert tp.spec.obs_spec.shape == jp.spec.obs_spec.shape
        got = host_rollout(tp, tp.spec, STEPS)
        want = host_rollout(jp, tp.spec, STEPS)
        stats = tp.stats()
        assert_stats_equal(jp.stats(), stats, f"{task} {engine}")
    finally:
        tp.close()
        jp.close()
    compare_blocks(f"{task} {engine} vs repro", got, want, atol=atol,
                   obs_atol=obs_atol)
    assert any(b["done"].any() for b in got)

    dp = repro_torch.make(task, num_envs=N, device="cpu", max_episode_steps=5)
    dev, dev_stats = device_rollout(dp, STEPS)
    compare_blocks(f"{task} {engine} vs device", reset_cost_as_device(got),
                   dev, obs_atol=1e-3 if task == "AntNorm-v3" else 0.0)
    assert_stats_equal(dev_stats, stats, f"{task} {engine} vs device")


@pytest.mark.parametrize("task,transforms,shape", [
    ("PongClassic-v5", [], (210, 160, 3)),
    ("PongClassic-v5", None, (4, 84, 84)),
    ("AntNorm-v3", [], (29,)),
])
def test_raw_and_default_pipelines_match_repro(task, transforms, shape):
    """``transforms=[]`` serves the raw stream, the task's default its
    registered pipeline, in both packages; the thread engine here."""
    kw = dict(num_envs=N, engine="thread", num_threads=2,
              max_episode_steps=5, transforms=transforms)
    tp = repro_torch.make(task, device="cpu", **kw)
    jp = jax_registry.make(task, **kw)
    try:
        assert tuple(tp.spec.obs_spec.shape) == shape
        got = host_rollout(tp, tp.spec, 6)
        want = host_rollout(jp, tp.spec, 6)
    finally:
        tp.close()
        jp.close()
    compare_blocks(f"{task} {transforms}", got, want,
                   atol=1e-4 if task.startswith("Ant") else 0.0)
    assert got[-1]["obs"].shape == (N,) + shape
    assert got[-1]["obs"].dtype == np.dtype(
        np.uint8 if task.startswith("Pong") else np.float32)
