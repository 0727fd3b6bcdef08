"""The port's PPO arithmetic against the JAX package run live:
``random.permutation``, GAE, the learning-rate schedules, global-norm
clipping, AdamW and SGD (``repro_torch.optim``, ``repro_torch.rl.gae``).

Tolerances: ``permutation`` is bitwise, at sizes that take 0, 1 and 2
shuffle rounds and at the main path's 524288 samples, where about 32
pairs of 32-bit sort keys collide and only a stable sort gives jax's
order.  Everything else is float32 arithmetic in the same order as the
JAX package's and is held to 1e-6 (absolute and relative): a reduction
may sum in another order, and ``b ** count`` is XLA's ``pow`` against
torch's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.optim as joptim  # noqa: E402
from repro.rl.gae import gae as jgae  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.rl.gae import gae as tgae  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 100, 1625, 1626, 5000, 524288])
@pytest.mark.parametrize("seed", [0, 11])
def test_permutation_is_bitwise(n, seed):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    got = R.permutation(R.PRNGKey(seed), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_permutation_ties_decide_the_order():
    """At the main path's size, some of a round's 32-bit sort keys
    collide, so the order a sort gives equal keys changes the
    permutation: taking ties in reverse gives another one."""
    n = 524288
    keys = R.bits(R.split(R.PRNGKey(0))[1], (n,))
    assert keys.unique().numel() < n
    idx = torch.arange(n)
    stable = torch.sort(keys, stable=True).indices
    reverse = torch.sort(keys * n + (n - 1 - idx)).indices
    assert not torch.equal(stable, reverse)


def test_permutation_refuses_a_key_batch():
    with pytest.raises(ValueError, match="one key"):
        R.permutation(R.split(R.PRNGKey(0), 2), 5)


def _rollout(T, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (T, N)).astype(np.float32),
            rng.normal(0, 1, (T, N)).astype(np.float32),
            rng.random((T, N)) < 0.2,
            rng.normal(0, 1, (N,)).astype(np.float32))


@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (0.9, 1.0)])
def test_gae_matches_repro(gamma, lam):
    r, v, d, last = _rollout(16, 6, 3)
    assert d.any()
    want = jgae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d),
                jnp.asarray(last), gamma, lam)
    got = tgae(torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(d),
               torch.from_numpy(last), gamma, lam)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name,args", [
    ("linear_decay", (2.5e-4, 64)),
    ("constant", (3e-4,)),
    ("linear_warmup_cosine", (1e-3, 10, 100)),
    ("linear_warmup_cosine", (1e-3, 0, 50, 0.0)),
])
def test_schedules_match_repro(name, args):
    jf = getattr(joptim, name)(*args)
    tf = getattr(toptim, name)(*args)
    for step in [0, 1, 5, 10, 11, 50, 63, 64, 100, 200]:
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(jf(step)), **TOL)
        np.testing.assert_allclose(float(tf(step)), float(jf(step)), **TOL)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(0, scale, (5, 3)).astype(np.float32),
                  "b": rng.normal(0, scale, (3,)).astype(np.float32)},
            "c": rng.normal(0, scale, (7,)).astype(np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _assert_trees_close(got, want, **tol):
    want = jax.tree.map(np.asarray, want)
    got = jax.tree.map(lambda x: x.numpy(), got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, **(tol or TOL))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_repro(max_norm):
    tree = _tree(0)
    jt, jn = joptim.clip_by_global_norm(_j(tree), max_norm)
    tt, tn = toptim.clip_by_global_norm(_t(tree), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    np.testing.assert_allclose(float(toptim.global_norm(_t(tree))),
                               float(joptim.global_norm(_j(tree))), **TOL)
    _assert_trees_close(tt, jt)


@pytest.mark.parametrize("kw", [
    dict(b1=0.9, b2=0.999, eps=1e-5, weight_decay=0.0, clip_norm=0.5),
    dict(),
    dict(weight_decay=0.01, clip_norm=None),
])
def test_adamw_matches_repro_over_steps(kw):
    params = _tree(1)
    jo, to = joptim.adamw(**kw), toptim.adamw(**kw)
    jp, tp = _j(params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    assert ts.count.dtype == torch.int32
    lr = toptim.linear_decay(1e-2, 8)
    for step in range(6):
        grads = _tree(100 + step, scale=0.3 + step)
        jp, js = jo.update(_j(grads), js, jp, float(lr(step)))
        tp, ts = to.update(_t(grads), ts, tp, lr(torch.tensor(step)))
    _assert_trees_close(tp, jp)
    _assert_trees_close(ts.mu, js.mu)
    _assert_trees_close(ts.nu, js.nu)
    assert int(ts.count) == int(js.count) == 6


@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_sgd_matches_repro(clip_norm):
    params = _tree(2)
    jo = joptim.sgd(lr_scale=0.5, clip_norm=clip_norm)
    to = toptim.sgd(lr_scale=0.5, clip_norm=clip_norm)
    jp, tp = _j(params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = _tree(200 + step)
        jp, js = jo.update(_j(grads), js, jp, 0.1)
        tp, ts = to.update(_t(grads), ts, tp, 0.1)
    _assert_trees_close(tp, jp)
    assert int(ts) == int(js) == 3
