"""The port's MoE FFN (``models/moe.py``) against the JAX package's
(``repro/models/moe.py``), run live in one process on the same numpy
inputs and weights (``repro``'s ``moe_init``):

* ``_route_group`` over a batch of groups (``repro``'s vmapped): slots
  and keep bitwise, gates and the aux loss within 2e-4, on a random
  router, and on a zero router where every probability ties (the
  stable sort must pick the lower expert first, as ``lax.top_k``);
* ``apply_moe`` with ``repro``'s capacity and with ``capacity_factor``
  0.5, where tokens are dropped, for swiglu and gelu experts;
* its gradients, in the input and every weight, against ``jax.grad``.

Everything runs in f32 at the smoke size (d 64, 4 experts top-2, d_ff
128).  Tolerance 2e-4, as the model tests use (the products and sums
run in another order); each gradient leaf within 2e-4 of its largest
entry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import moe as JM  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.common import MoEConfig  # noqa: E402

TOL = 2e-4


def configs(name: str = "dbrx-132b", **variant):
    """(repro config, port config), f32 compute, ``variant`` applied."""
    jcfg = j_smoke(name).replace(compute_dtype=jnp.float32, **variant)
    tcfg = get_smoke_config(name).replace(compute_dtype=torch.float32,
                                          **variant)
    return jcfg, tcfg


def moe_weights(jcfg, seed: int = 0):
    """``repro``'s ``moe_init`` weights, as jnp and as torch tensors."""
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


@pytest.mark.parametrize("router_kind,C", [
    ("random", 16), ("random", 3), ("zero", 1), ("zero", 5)])
def test_route_group_matches_repro(router_kind, C):
    jcfg, tcfg = configs()
    E = tcfg.moe.num_experts
    x = normal((3, 32, tcfg.d_model), seed=1)
    router = (normal((tcfg.d_model, E), seed=2) if router_kind == "random"
              else np.zeros((tcfg.d_model, E), np.float32))
    jslot, jgates, jkeep, jaux = jax.vmap(
        lambda xt: JM._route_group(xt, jnp.asarray(router), jcfg, C))(
        jnp.asarray(x))
    slot, gates, keep, aux = TM._route_group(
        torch.from_numpy(x), torch.from_numpy(router), tcfg, C)
    assert slot.shape == keep.shape == gates.shape == (3, 32 * 2)
    assert aux.shape == (3,)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=TOL,
                               atol=TOL)
    if router_kind == "zero":
        # every token ties: experts 0 and 1, each taking C tokens a group
        assert int(keep.sum()) == 3 * 2 * C
        np.testing.assert_array_equal(
            (slot[:, :2 * C] // C).numpy(), np.tile([0, 1], (3, C)))


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_apply_moe_matches_repro(mlp_type, capacity_factor):
    jcfg, tcfg = configs(mlp_type=mlp_type)
    jcfg = jcfg.replace(moe=jcfg.moe.__class__(
        num_experts=4, top_k=2, capacity_factor=capacity_factor))
    tcfg = tcfg.replace(moe=MoEConfig(4, 2, capacity_factor=capacity_factor))
    jp, tp = moe_weights(jcfg, seed=3)
    assert set(tp) == ({"router", "wi", "wo", "wg"} if mlp_type == "swiglu"
                       else {"router", "wi", "wo"})
    x = normal((2, 24, tcfg.d_model), seed=4)
    want, jaux = JM.apply_moe(jp, jnp.asarray(x), jcfg)
    got, aux = TM.apply_moe(tp, torch.from_numpy(x), tcfg)
    assert got.shape == x.shape and aux.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)
    if capacity_factor < 1:
        # C = int(24 * 2 * 0.5 / 4) = 6 of the 12 picks an expert gets on
        # average: some (token, k) pairs are dropped
        C = max(1, int(24 * 2 * capacity_factor / 4))
        slot = TM._route_group(torch.from_numpy(x), tp["router"], tcfg,
                               C)[0]
        assert int((slot == 4 * C).sum()) > 0


def test_apply_moe_grads_match_repro():
    jcfg, tcfg = configs()
    jp, tp = moe_weights(jcfg, seed=5)
    x = normal((2, 16, tcfg.d_model), seed=6)
    r = normal((2, 16, tcfg.d_model), seed=7)

    def jloss(p, xx):
        out, aux = JM.apply_moe(p, xx, jcfg)
        return jnp.sum(out * jnp.asarray(r)) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = TM.apply_moe(leaves, tx, tcfg)
    ((out * torch.from_numpy(r)).sum() + aux).backward()
    pairs = [("x", tx.grad, jgx)] + [(k, leaves[k].grad, jgp[k])
                                     for k in jgp]
    for name, got, want in pairs:
        want = np.asarray(want)
        assert got is not None, name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max()) / scale
        assert err <= TOL, (name, err)


def test_moe_init_layout_matches_repro():
    for name in ("dbrx-132b", "granite-moe-3b-a800m"):
        jcfg, tcfg = configs(name)
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in JM.moe_init(jax.random.PRNGKey(0), jcfg).items()}
        got = TM.moe_init(torch.Generator().manual_seed(0), tcfg, "cpu",
                          lead=(3,))
        assert {k: (tuple(v.shape[1:]), str(v.dtype).removeprefix("torch."))
                for k, v in got.items()} == want
        assert all(v.shape[0] == 3 for v in got.values())
