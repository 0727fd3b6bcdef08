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
