"""The port's selective SSM branch (``models/ssm.py``) against the JAX
package's (``repro/models/ssm.py``), run live in one process on the
same numpy inputs and weights (``repro``'s ``ssm_init``):

* ``_causal_conv`` with and without a tail;
* ``apply_ssm``'s chunked scan over several chunks, from zeros and from
  a carried state, and its ``S == 1`` decode step;
* a prefill then decode steps equal to one pass over all the tokens,
  and both equal to ``repro``'s;
* gradients in the input and every weight against ``jax.grad``;
* the Hillis-Steele chunk prefixes against a loop over tokens, the
  state layout in the compute dtype, and a sequence that is no multiple
  of the chunk refused, as ``repro`` asserts.

Everything runs in f32 at the smoke size (d 64, state 4, conv width 4,
chunk 8).  Tolerance 2e-4, as the model tests use: the scan's products
are associated in another order than XLA's associative scan, which
moves the last bits of f32; each gradient leaf within 2e-4 of its
largest entry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import ssm as JS  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

TOL = 2e-4


def configs(**variant):
    """(repro config, port config) of smoke hymba-1.5b, f32 compute."""
    jcfg = j_smoke("hymba-1.5b").replace(compute_dtype=jnp.float32,
                                         **variant)
    tcfg = get_smoke_config("hymba-1.5b").replace(
        compute_dtype=torch.float32, **variant)
    return jcfg, tcfg


def ssm_weights(jcfg, seed: int = 0):
    """``repro``'s ``ssm_init`` weights, as jnp and as torch tensors."""
    jp = JS.ssm_init(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def close(got, want) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def state_of(jcfg, B: int, seed: int):
    """A nonzero (h, conv_tail) state as numpy arrays."""
    di, n, W = jcfg.d_model, jcfg.ssm.state_dim, jcfg.ssm.conv_width
    return normal((B, di, n), seed, 0.5), normal((B, W - 1, di), seed + 1)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_repro(with_tail):
    x = normal((2, 11, 64), seed=1)
    w = normal((4, 64), seed=2, scale=0.1)
    tail = normal((2, 3, 64), seed=3) if with_tail else None
    want, want_tail = JS._causal_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if tail is None else jnp.asarray(tail))
    got, got_tail = TS._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if tail is None else torch.from_numpy(tail))
    close(got, want)
    np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))


@pytest.mark.parametrize("S,with_state", [(32, False), (32, True),
                                          (8, True), (1, True), (1, False)])
def test_apply_ssm_matches_repro(S, with_state):
    """S = 32 runs 4 chunks of 8, S = 8 one, S = 1 the decode step."""
    jcfg, tcfg = configs()
    jp, tp = ssm_weights(jcfg, seed=4)
    x = normal((2, S, 64), seed=5)
    st = state_of(jcfg, 2, seed=6) if with_state else None
    want, (jh, jtail) = JS.apply_ssm(
        jp, jnp.asarray(x), jcfg,
        None if st is None else tuple(map(jnp.asarray, st)))
    got, (h, tail) = TS.apply_ssm(
        tp, torch.from_numpy(x), tcfg,
        None if st is None else tuple(map(torch.from_numpy, st)))
    assert got.shape == (2, S, 64) and h.shape == (2, 64, 4)
    assert tail.shape == (2, 3, 64)
    close(got, want)
    close(h, jh)
    close(tail, jtail)


def test_prefill_then_decode_equals_one_pass():
    jcfg, tcfg = configs()
    jp, tp = ssm_weights(jcfg, seed=7)
    x = normal((2, 20, 64), seed=8)
    full, (h_full, tail_full) = TS.apply_ssm(tp, torch.from_numpy(x[:, :16]),
                                             tcfg)
    outs, state = [full], (h_full, tail_full)
    jout, jstate = JS.apply_ssm(jp, jnp.asarray(x[:, :16]), jcfg)
    jouts = [jout]
    for t in range(16, 20):
        out, state = TS.apply_ssm(tp, torch.from_numpy(x[:, t:t + 1]), tcfg,
                                  state)
        jout, jstate = JS.apply_ssm(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                    jstate)
        outs.append(out)
        jouts.append(jout)
    stepped = torch.cat(outs, dim=1)
    close(stepped, jnp.concatenate(jouts, axis=1))
    close(state[0], jstate[0])
    close(state[1], jstate[1])
    # the same 20 tokens as one pass (chunk 4 divides 20)
    once, (h, tail) = TS.apply_ssm(
        tp, torch.from_numpy(x), tcfg.replace(ssm=tcfg.ssm.__class__(
            state_dim=4, conv_width=4, expand=1, chunk=4)))
    close(stepped, once)
    close(state[0], h)
    close(state[1], tail)


def test_apply_ssm_grads_match_repro():
    jcfg, tcfg = configs()
    jp, tp = ssm_weights(jcfg, seed=9)
    x = normal((2, 16, 64), seed=10)
    r = normal((2, 16, 64), seed=11)

    def jloss(p, xx):
        out, _ = JS.apply_ssm(p, xx, jcfg)
        return jnp.sum(out * jnp.asarray(r))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = TS.apply_ssm(leaves, tx, tcfg)
    (out * torch.from_numpy(r)).sum().backward()
    pairs = [("x", tx.grad, jgx)] + [(k, leaves[k].grad, jgp[k])
                                     for k in jgp]
    for name, got, want in pairs:
        want = np.asarray(want)
        assert got is not None, name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max()) / scale
        assert err <= TOL, (name, err)


def test_chunk_prefixes_match_a_token_loop():
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 3, 16, 5, 4)))
    b = torch.from_numpy(rng.normal(0, 1, (2, 3, 16, 5, 4)))
    a_c, b_c = TS._chunk_prefixes(a, b)
    pa, pb = a[:, :, 0], b[:, :, 0]
    for t in range(16):
        if t:
            pa, pb = pa * a[:, :, t], a[:, :, t] * pb + b[:, :, t]
        torch.testing.assert_close(a_c[:, :, t], pa, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(b_c[:, :, t], pb, rtol=1e-12, atol=1e-12)
    h0 = torch.from_numpy(rng.normal(0, 1, (2, 5, 4)))
    h_seq, h_last = TS._chunked_scan(h0, a.reshape(2, 48, 5, 4),
                                     b.reshape(2, 48, 5, 4), 16)
    h = h0
    for t in range(48):
        h = a.reshape(2, 48, 5, 4)[:, t] * h + b.reshape(2, 48, 5, 4)[:, t]
        torch.testing.assert_close(h_seq[:, t], h, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(h_last, h_seq[:, -1], rtol=0, atol=0)


def test_state_layout_and_refusal():
    jcfg, tcfg = j_smoke("hymba-1.5b"), get_smoke_config("hymba-1.5b")
    jh, jtail = JS.init_ssm_state(jcfg, 3, 2)
    h, tail = TS.init_ssm_state(tcfg, 3, 2, "cpu")
    for got, want in ((h, jh), (tail, jtail)):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        assert not bool(got.any())
    # bf16 compute: the returned state is cast to it, as repro's
    jp, tp = ssm_weights(jcfg, seed=13)
    x = normal((1, 8, 64), seed=14)
    _, (jh, jtail) = JS.apply_ssm(jp, jnp.asarray(x).astype(jnp.bfloat16),
                                  jcfg)
    _, (h, tail) = TS.apply_ssm(tp, torch.from_numpy(x).bfloat16(), tcfg)
    assert h.dtype == tail.dtype == torch.bfloat16
    assert str(jh.dtype) == str(jtail.dtype) == "bfloat16"
    with pytest.raises(ValueError, match="multiple"):
        TS.apply_ssm(tp, torch.zeros((1, 12, 64), dtype=torch.bfloat16),
                     tcfg)
    with pytest.raises(AssertionError):
        JS.apply_ssm(jp, jnp.zeros((1, 12, 64)), jcfg)
