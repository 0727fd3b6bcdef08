"""The port's batched physics (kernels/env_step) against the JAX package:
the plain version the wrapper takes for CPU tensors, held against
``env_substep_batch`` run in Pallas interpret mode and against its
reference op.

Tolerance atol=rtol=1e-5: XLA fuses ``a*b + c`` into fused multiply-adds
and its ``cos`` differs from torch's by an ulp on some inputs, so the
float streams agree to rounding, not bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels.env_step.kernel import env_substep_batch  # noqa: E402
from repro.kernels.env_step.ref import (  # noqa: E402
    env_multi_substep_reference as jax_reference,
)
from repro_torch.kernels.backend import resolve_backend  # noqa: E402
from repro_torch.kernels.env_step.ops import env_multi_step  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def inputs(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    state = np.zeros((n, 28), np.float32)
    state[:, 0:2] = rng.normal(0, 1, (n, 2))
    state[:, 2] = rng.uniform(0.15, 0.9, n)        # some feet touch down
    state[:, 3:12] = rng.normal(0, 0.3, (n, 9))
    state[:, 12:20] = rng.uniform(-1.2, 1.2, (n, 8))
    state[:, 20:28] = rng.normal(0, 1.0, (n, 8))
    action = rng.uniform(-1.3, 1.3, (n, 8)).astype(np.float32)
    cost = rng.integers(5, 10, n).astype(np.int32)
    reward0 = rng.normal(0, 1, n).astype(np.float32)
    return state, action, cost, reward0


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", [8, 64])
def test_masked_multi_substep_matches_jax(n):
    state, action, cost, reward0 = inputs(n, seed=n)
    s, r = env_multi_step(t(state), t(action), t(cost), t(reward0), n_sub=9)
    ks, kr = env_substep_batch(jnp.asarray(state), jnp.asarray(action),
                               jnp.asarray(cost), jnp.asarray(reward0),
                               n_sub=9, interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(ks), **TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(kr), **TOL)
    rs, rr = jax_reference(jnp.asarray(state), jnp.asarray(action),
                           jnp.asarray(cost), jnp.asarray(reward0))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(rr), **TOL)


def test_uniform_variant_matches_jax():
    state, action, _, _ = inputs(16, seed=3)
    s, r = env_multi_step(t(state), t(action), n_sub=5)
    ks, kr = env_substep_batch(jnp.asarray(state), jnp.asarray(action),
                               n_sub=5, interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(ks), **TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(kr), **TOL)


def test_zero_cost_lanes_are_frozen_exactly():
    state, action, cost, reward0 = inputs(8, seed=5)
    cost[::2] = 0
    s, r = env_multi_step(t(state), t(action), t(cost), t(reward0), n_sub=9)
    np.testing.assert_array_equal(s.numpy()[::2], state[::2])
    np.testing.assert_array_equal(r.numpy()[::2], reward0[::2])
    assert not np.array_equal(s.numpy()[1::2], state[1::2])


def test_backend_rule_takes_the_plain_version_only_for_cpu_tensors():
    x = torch.zeros(2)
    assert resolve_backend("auto", x) == "reference"
    assert resolve_backend("reference", x) == "reference"
    with pytest.raises(ValueError):
        resolve_backend("cuda", x)
    with pytest.raises(ValueError):
        resolve_backend("pallas", x)
    state, action, cost, reward0 = inputs(4)
    with pytest.raises(ValueError):
        env_multi_step(t(state), t(action), t(cost), t(reward0), n_sub=9,
                       backend="cuda")


def test_env_step_plan_covers_every_lane_once():
    """For N in 1..5000 the launch has threads for every lane's group
    and no block without a lane; a group lies inside one warp."""
    from repro_torch.kernels.env_step.ops import (
        ENV_GROUP,
        ENV_THREADS,
        env_step_plan,
    )

    assert ENV_THREADS % 32 == 0 and 32 % ENV_GROUP == 0
    for n in range(1, 5001):
        blocks = env_step_plan(n)
        threads = blocks * ENV_THREADS
        assert threads >= n * ENV_GROUP > threads - ENV_THREADS


@pytest.mark.parametrize("n", [1, 3, 1000, 2048, 4096])
def test_env_step_plan_lanes_at_main_path_sizes(n):
    """Thread ``i`` of the grid serves lane ``i // ENV_GROUP`` as member
    ``i % ENV_GROUP``: each lane gets exactly ``ENV_GROUP`` threads, all
    in one warp, and threads past the last lane form whole groups."""
    from repro_torch.kernels.env_step.ops import (
        ENV_GROUP,
        ENV_THREADS,
        env_step_plan,
    )

    tid = np.arange(env_step_plan(n) * ENV_THREADS)
    lane, member = tid // ENV_GROUP, tid % ENV_GROUP
    live = lane < n
    counts = np.bincount(lane[live], minlength=n)
    np.testing.assert_array_equal(counts, ENV_GROUP)
    first = tid[member == 0]
    assert np.all(first // 32 == (first + ENV_GROUP - 1) // 32)
    assert np.all(lane[~live] >= n)
