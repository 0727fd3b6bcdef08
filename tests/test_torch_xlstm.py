"""The port's xLSTM (``models/xlstm.py``, family ``ssm``) against the
JAX package's (``repro/models/xlstm.py``), run live in one process on
the same numpy inputs and weights (``repro``'s inits, carried across by
``params_from_jax``):

* ``apply_mlstm``'s recurrent step (S = 1) and its chunkwise form (one
  and three chunks), each from zeros and from a carried state;
* ``apply_slstm``'s token loop, from zeros and from a carried state;
* the LM's logits and per-layer states; ``Model.prefill`` then
  ``decode_step``s equal to one pass over all the tokens, and to
  ``repro``'s, the cache's dtypes included (the mLSTM state in the
  compute dtype, the sLSTM's in f32);
* ``train_loss`` and its gradients against ``jax.value_and_grad`` at the
  smoke chunk of 8;
* the one divergence, at the configuration's own chunk of 256: the
  port's forward equals ``repro``'s, its gradient is finite and equals
  its own at chunk 8, while ``repro``'s gradient is not finite (its
  decay matrix is ``where(tri, exp(logD), 0)``: ``exp`` overflows above
  the diagonal and the backward multiplies the inf by 0);
* a sequence that is no multiple of the chunk is refused, as ``repro``
  asserts.

Everything runs in f32 at the smoke size (d 64, 4 heads, an mLSTM and
an sLSTM layer, chunk 8).  Tolerances: outputs, logits and states within
2e-4, the loss within 1e-5, each gradient leaf within 2e-4 of its
largest entry (the products and sums run in another order); the chunk
256 and chunk 8 gradients of the port within 1e-4 of their largest
entry (the same function, its sums associated by another chunking).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import build_model as j_build  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402

from _torch_family import (  # noqa: E402
    assert_leaves_close,
    close,
    configs,
    leaves,
    normal,
    tokens,
    weights,
)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

ARCH = "xlstm-125m"


def block_weights(init, jcfg, seed: int):
    jp = init(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 8, 24])
def test_apply_mlstm_matches_repro(S, with_state):
    jcfg, tcfg = configs(ARCH)
    jp, tp = block_weights(JX.mlstm_init, jcfg, seed=S)
    x = normal((2, S, 64), seed=1)
    _, dh = TX.mlstm_dims(tcfg)
    state = None
    if with_state:
        state = (normal((2, 4, dh, dh), seed=2, scale=0.3),
                 normal((2, 4, dh), seed=3, scale=0.3))
    want, (wC, wn) = JX.apply_mlstm(
        jp, jnp.asarray(x), jcfg,
        None if state is None else tuple(map(jnp.asarray, state)))
    got, (gC, gn) = TX.apply_mlstm(
        tp, torch.from_numpy(x), tcfg,
        None if state is None else tuple(map(torch.from_numpy, state)))
    close(got, want)
    close(gC, wC)
    close(gn, wn)


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_slstm_matches_repro(with_state):
    jcfg, tcfg = configs(ARCH)
    jp, tp = block_weights(JX.slstm_init, jcfg, seed=4)
    x = normal((2, 13, 64), seed=5)
    state = None
    if with_state:
        state = (normal((2, 64), 6, 0.5), normal((2, 64), 7, 0.5),
                 np.abs(normal((2, 64), 8)) + 1.0, normal((2, 64), 9, 0.5))
    want, wstate = JX.apply_slstm(
        jp, jnp.asarray(x), jcfg,
        None if state is None else tuple(map(jnp.asarray, state)))
    got, gstate = TX.apply_slstm(
        tp, torch.from_numpy(x), tcfg,
        None if state is None else tuple(map(torch.from_numpy, state)))
    close(got, want)
    assert all(s.dtype == torch.float32 for s in gstate)
    for g, w in zip(gstate, wstate):
        close(g, w)


def test_lm_logits_and_states_match_repro():
    jcfg, tcfg = configs(ARCH)
    jparams, tparams = weights(jcfg, tcfg)
    assert TX.xlstm_block_kinds(tcfg) == ["mlstm", "slstm"]
    tok = tokens(tcfg.vocab, (2, 24), seed=1)
    want, wstates = jax.jit(JX.xlstm_lm_apply, static_argnums=2)(
        jparams, jnp.asarray(tok), jcfg)
    got, gstates = TX.xlstm_lm_apply(tparams, torch.from_numpy(tok), tcfg)
    assert got.shape == (2, 24, tcfg.vocab)
    close(got, want)
    assert_leaves_close(leaves(gstates), leaves(wstates), 2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_equals_one_pass(dtype):
    jcfg, tcfg = configs(ARCH)
    jparams, tparams = weights(jcfg, tcfg)
    cd = getattr(torch, dtype)
    tcfg = tcfg.replace(compute_dtype=cd)
    jcfg = jcfg.replace(compute_dtype=getattr(jnp, dtype))
    tm, jm = build_model(tcfg, "cpu"), j_build(jcfg)
    tok = tokens(tcfg.vocab, (2, 24), seed=2)
    full, _ = TX.xlstm_lm_apply(tparams, torch.from_numpy(tok), tcfg)
    logits, cache = tm.prefill(tparams, {"tokens": torch.from_numpy(
        tok[:, :16])}, max_len=20)
    jlog, jcache = jax.jit(jm.prefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(tok[:, :16])}, 20)
    jdecode = jax.jit(jm.decode_step)
    # the cache: repro's layout and dtypes, the mLSTM state in the
    # compute dtype and the sLSTM's in f32
    assert int(cache["len"]) == int(jcache["len"]) == 16
    got_t = [[(tuple(t.shape), str(t.dtype).removeprefix("torch."))
              for t in st] for st in cache["states"]]
    want_t = [[(tuple(t.shape), str(t.dtype)) for t in st]
              for st in jcache["states"]]
    assert got_t == want_t
    assert got_t[0][0][1] == dtype and got_t[1][0][1] == "float32"
    empty = tm.init_cache(2, 20)
    assert [[(tuple(t.shape), t.dtype) for t in st]
            for st in empty["states"]] == [[(tuple(t.shape), t.dtype)
                                            for t in st]
                                           for st in cache["states"]]
    tol = 2e-4 if dtype == "float32" else 5e-2
    for t in range(16, 20):
        close(logits, full[:, t - 1], tol)
        close(logits, jlog, tol)
        logits, cache = tm.decode_step(tparams, torch.from_numpy(
            tok[:, t:t + 1]), cache)
        jlog, jcache = jdecode(jparams, jnp.asarray(tok[:, t:t + 1]),
                               jcache)
    close(logits, jlog, tol)
    assert int(cache["len"]) == 20


def grads(jcfg, tcfg, jparams, tparams, tok):
    """(repro's loss and gradient tree, the port's) of next-token
    prediction over ``tok``."""
    jbatch = {"tokens": jnp.asarray(tok[:, :-1]),
              "labels": jnp.asarray(tok[:, 1:])}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        j_build(jcfg).train_loss, has_aux=True))(jparams, jbatch)
    loss, _, tg = tsteps.loss_and_grads(
        build_model(tcfg, "cpu"), tparams,
        {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()})
    return (float(jloss), leaves(jg)), (float(loss), leaves(tg))


def test_train_loss_and_grads_match_repro():
    jcfg, tcfg = configs(ARCH)
    jparams, tparams = weights(jcfg, tcfg, seed=3)
    tok = tokens(tcfg.vocab, (2, 33), seed=3)
    (jloss, jg), (loss, tg) = grads(jcfg, tcfg, jparams, tparams, tok)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
    assert_leaves_close(tg, jg, 2e-4)


def test_chunk_256_gradient_is_finite_where_repro_is_not():
    """The configuration's own chunk: ``repro``'s mLSTM gradient is not
    finite (``exp`` of the decay matrix overflows above the diagonal
    before ``where`` masks it, and the backward multiplies the inf by
    0); the port masks before the ``exp``, so its forward is
    ``repro``'s and its gradient is finite and equals its own at the
    smoke chunk of 8."""
    jcfg, tcfg = configs(ARCH)
    jparams, tparams = weights(jcfg, tcfg, seed=5)
    tok = tokens(tcfg.vocab, (2, 257), seed=5)
    big_j = jcfg.replace(xlstm=jcfg.xlstm.__class__(2, 1, 256))
    big_t = tcfg.replace(xlstm=tcfg.xlstm.__class__(2, 1, 256))
    want, _ = jax.jit(JX.xlstm_lm_apply, static_argnums=2)(
        jparams, jnp.asarray(tok[:, :-1]), big_j)
    got, _ = TX.xlstm_lm_apply(tparams, torch.from_numpy(tok[:, :-1]), big_t)
    close(got, want)
    (jloss, jg), (loss, tg) = grads(big_j, big_t, jparams, tparams, tok)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
    assert sum(int((~np.isfinite(g)).sum()) for g in jg.values()) > 0
    assert all(np.isfinite(g).all() for g in tg.values())
    small = tsteps.loss_and_grads(
        build_model(tcfg, "cpu"), tparams,
        {"tokens": torch.from_numpy(tok[:, :-1]),
         "labels": torch.from_numpy(tok[:, 1:])})[2]
    assert_leaves_close(tg, leaves(small), 1e-4)


def test_sequence_not_a_multiple_of_the_chunk_is_refused():
    _, tcfg = configs(ARCH)
    p = TX.mlstm_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    with pytest.raises(ValueError, match="multiple of the mLSTM chunk 8"):
        TX.apply_mlstm(p, torch.zeros((1, 12, 64)), tcfg)
