"""The port's Whisper encoder-decoder (``models/whisper.py``, family
``encdec``) against the JAX package's (``repro/models/whisper.py``),
run live in one process on the same numpy frames, tokens and weights
(``repro``'s ``whisper_init``, carried across by ``params_from_jax``):

* ``encode``: bidirectional attention over the frames plus sinusoidal
  positions;
* ``decode`` without a cache: causal self-attention and cross-attention
  over the encoder's output;
* ``Model.prefill`` then ``decode_step``s against the no-cache logits
  (as tests/test_models.py holds ``repro``'s), and against ``repro``'s
  prefill and decode steps, the cache's leaves included (the cross K/V
  built at prefill, read after);
* the decoder's positions read at ``len`` clamped so that ``len + S <=
  max_seq``, as ``lax.dynamic_slice`` clamps its start;
* ``train_loss`` and its gradients against ``jax.value_and_grad``; the
  cache's layout and ``params_from_jax``'s shape checks.

Everything runs in f32 at the smoke size (d 64, 4 heads of 16, 2
encoder and 2 decoder layers, 16 frames, max_seq 256).  Tolerances:
states, logits and caches within 2e-4, the loss within 1e-5, each
gradient leaf within 2e-4 of its largest entry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import build_model as j_build  # noqa: E402
from repro.models import whisper as JW  # noqa: E402

from _torch_family import (  # noqa: E402
    assert_leaves_close,
    close,
    configs,
    f32,
    leaves,
    normal,
    tokens,
    weights,
)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import whisper as TW  # noqa: E402
from repro_torch.models.layers import _slice_index  # noqa: E402
from repro_torch.rl import policy_lm as tlm  # noqa: E402

ARCH = "whisper-large-v3"


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs(ARCH)
    jparams, tparams = weights(jcfg, tcfg)
    frames = normal((2, tcfg.enc_seq, tcfg.d_model), seed=1)
    return jcfg, tcfg, jparams, tparams, frames


def test_encode_matches_repro(pair):
    jcfg, tcfg, jparams, tparams, frames = pair
    want = JW.encode(jparams, jnp.asarray(frames), jcfg)
    got = TW.encode(tparams, torch.from_numpy(frames), tcfg)
    assert got.shape == (2, 16, 64)
    close(got, want)


def test_decode_without_cache_matches_repro(pair):
    jcfg, tcfg, jparams, tparams, frames = pair
    tok = tokens(tcfg.vocab, (2, 10), seed=2)
    enc = JW.encode(jparams, jnp.asarray(frames), jcfg)
    want, _ = JW.decode(jparams, jnp.asarray(tok), enc, jcfg)
    got, cache = TW.decode(tparams, torch.from_numpy(tok),
                           torch.tensor(f32(enc)), tcfg)
    assert cache is None and got.shape == (2, 10, tcfg.vocab)
    close(got, want)


def test_prefill_and_decode_match_the_no_cache_logits(pair):
    jcfg, tcfg, jparams, tparams, frames = pair
    tok = tokens(tcfg.vocab, (2, 12), seed=3)
    tm, jm = build_model(tcfg, "cpu"), j_build(jcfg)
    enc = TW.encode(tparams, torch.from_numpy(frames), tcfg)
    full, _ = TW.decode(tparams, torch.from_numpy(tok), enc, tcfg)
    batch = {"tokens": tok[:, :6], "frames": frames}
    logits, cache = tm.prefill(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        max_len=16)
    jlog, jcache = jax.jit(jm.prefill, static_argnums=2)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, 16)
    jdecode = jax.jit(jm.decode_step)
    for t in range(6, 12):
        close(logits, full[:, t - 1])
        close(logits, jlog)
        assert set(cache) == set(jcache)
        assert int(cache["len"]) == int(jcache["len"]) == t
        for name in ("k", "v", "xk", "xv"):
            assert cache[name].dtype == torch.float32
            close(cache[name], jcache[name], msg=name)
        logits, cache = tm.decode_step(tparams, torch.from_numpy(
            tok[:, t:t + 1]), cache)
        jlog, jcache = jdecode(jparams, jnp.asarray(tok[:, t:t + 1]), jcache)
    close(logits, jlog)


def test_decoder_positions_clamp_as_dynamic_slice(pair):
    """A cache holding ``len = max_seq - 2`` and 4 new tokens: the
    decoder reads ``dec_pos[max_seq - 4:]`` (the start clamped), where a
    plain slice from ``len`` would give 2 rows."""
    jcfg, tcfg, jparams, tparams, frames = pair
    M = tcfg.max_seq
    assert _slice_index(torch.tensor(M - 2), 4, M).tolist() == list(
        range(M - 4, M))
    tok = tokens(tcfg.vocab, (2, 4), seed=4)
    tm, jm = build_model(tcfg, "cpu"), j_build(jcfg)
    _, cache = tm.prefill(tparams, {"tokens": torch.from_numpy(tok[:, :1]),
                                    "frames": torch.from_numpy(frames)},
                          max_len=M + 8)
    _, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tok[:, :1]),
                                     "frames": jnp.asarray(frames)},
                           max_len=M + 8)
    cache["len"].fill_(M - 2)
    jcache["len"] = jnp.int32(M - 2)
    got, cache = TW.decode(tparams, torch.from_numpy(tok), None, tcfg, cache)
    want, jcache = JW.decode(jparams, jnp.asarray(tok), None, jcfg, jcache)
    close(got, want)
    close(cache["k"], jcache["k"])
    assert int(cache["len"]) == M + 2


def test_train_loss_and_grads_match_repro(pair):
    jcfg, tcfg, jparams, tparams, frames = pair
    tok = tokens(tcfg.vocab, (2, 13), seed=5)
    jbatch = {"tokens": jnp.asarray(tok[:, :-1]),
              "labels": jnp.asarray(tok[:, 1:]),
              "frames": jnp.asarray(frames)}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        j_build(jcfg).train_loss, has_aux=True))(jparams, jbatch)
    loss, metrics, tg = tsteps.loss_and_grads(
        build_model(tcfg, "cpu"), tparams,
        {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()})
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert_leaves_close(leaves(tg), leaves(jg), 2e-4)


def test_cache_layout_and_weight_checks(pair):
    jcfg, tcfg, jparams, _, _ = pair
    jc = j_build(jcfg).init_cache(3, 20)
    tc = build_model(tcfg, "cpu").init_cache(3, 20)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()} == {
        k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
        for k, v in tc.items()}
    assert tuple(tc["xk"].shape) == (2, 3, 16, 4, 16)
    bad = jax.tree.map(np.asarray, jparams)
    bad["dec_layers"] = jax.tree.map(lambda x: x[:1], bad["dec_layers"])
    with pytest.raises(ValueError, match="dec_layers.*want n_layers=2"):
        tlm.params_from_jax(bad, tcfg, "cpu")
    with pytest.raises(ValueError, match="dec_pos"):
        tlm.params_from_jax(jax.tree.map(np.asarray, jparams),
                            tcfg.replace(max_seq=128), "cpu")
