"""The port's LM training path against the JAX package's, run live in
one process with the same weights (``params_from_jax`` loads the numpy
leaves of ``repro``'s ``lm_init``):

* ``Model.train_loss`` and its gradients against ``jax.value_and_grad``
  of ``repro``'s, on the smoke configs of qwen3-0.6b, llama3.2-3b and
  starcoder2-3b, dense and blocked, full and sliding (window 32 over 48
  tokens: the banded branch), and of granite-moe-3b-a800m, dbrx-132b
  (the loss with the routers' aux loss) and hymba-1.5b (attention and
  SSM in parallel);
* three ``make_train_step`` steps on ``SyntheticSource`` batches, with
  ``microbatches`` 1 and 2: losses, ``aux`` (the MoE loss with one
  microbatch, zero with two, as ``repro`` reports it), learning rates
  and parameters;
* ``input_specs`` / ``synth_batch`` of train cells, ``train_state_shapes``
  against the real state, the data pipeline bitwise against
  ``repro.data``, and the checkpoint of a train state restored;
* the flash-attention gradient: ``plain_grads`` (whole and chunked)
  against autograd of ``mha_reference``, and ``_FlashAttentionFn``'s
  plumbing with its launch stood in for by the plain version.

Everything runs in f32; ``repro`` runs with ``scan_layers=False``, its
static per-layer windows, as the port does.  Tolerances: the loss
within 1e-5 (absolute and relative); each gradient leaf within 2e-5 of
its largest entry (the products and sums run in another order); after
three AdamW steps, losses within 1e-5, AdamW's first moments (a running
sum of the gradients) within 1e-4 of their leaf's largest entry, and
parameters within 1e-4 absolute, 1% of the peak learning rate: Adam
moves each weight by about ``lr`` a step whatever its gradient's size,
so a weight whose gradient is near zero (an embedding row seen once)
follows the rounding of that gradient's sign and size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.data as jdata  # noqa: E402
import repro.optim as joptim  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import count_params as j_count  # noqa: E402
from repro.models.common import (  # noqa: E402
    model_flops_per_token as j_flops,
)

import repro_torch.data as tdata  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    mha_reference,
)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import ShapeSpec, build_model  # noqa: E402
from repro_torch.models.api import softmax_xent  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    count_params,
    model_flops_per_token,
)
from repro_torch.rl import policy_lm as tlm  # noqa: E402
from repro_torch.utils.tree import tree_leaves_with_path  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
PARAM_TOL = 1e-4
MOMENT_TOL = 1e-4
SLIDING = dict(attn_type="sliding", window=32)


def configs(name: str, **variant):
    """(repro config, port config), f32 compute, ``variant`` applied."""
    jcfg = j_smoke(name).replace(compute_dtype=jnp.float32,
                                 scan_layers=False, **variant)
    tcfg = get_smoke_config(name).replace(compute_dtype=torch.float32,
                                          **variant)
    return jcfg, tcfg


def weights(jcfg, tcfg, seed: int = 0):
    jparams = JT.lm_init(jax.random.PRNGKey(seed),
                         jcfg.replace(scan_layers=True))
    tparams = tlm.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu")
    return jparams, tparams


def by_path(tree) -> dict:
    """Leaves of a ``repro`` pytree or a port tree, keyed by their dotted
    path (dict keys and dataclass fields)."""
    if isinstance(tree, dict) or hasattr(tree, "__dataclass_fields__"):
        return {p: np.asarray(v) if not isinstance(v, torch.Tensor)
                else v.detach().numpy()
                for p, v in tree_leaves_with_path(_as_torch_tree(tree))}
    raise TypeError(type(tree))


def _as_torch_tree(tree):
    """A ``repro`` pytree's dicts with numpy leaves as tensors, so that
    ``tree_leaves_with_path`` walks it."""
    if isinstance(tree, dict):
        return {k: _as_torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree
    return torch.from_numpy(np.array(tree))


def assert_leaves_close(got: dict, want: dict, tol: float) -> None:
    """Each leaf within ``tol`` times the largest entry of ``want``'s."""
    assert set(got) == set(want)
    for name in want:
        w, g = np.asarray(want[name], np.float64), np.asarray(got[name],
                                                            np.float64)
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, (name, err)


def tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("impl", ["dense", "blocked"])
@pytest.mark.parametrize("name,variant", [
    ("qwen3-0.6b", {}), ("llama3.2-3b", {}), ("starcoder2-3b", {}),
    ("qwen3-0.6b", SLIDING), ("starcoder2-3b", SLIDING),
    ("granite-moe-3b-a800m", {}), ("dbrx-132b", {}), ("hymba-1.5b", {})])
def test_train_loss_and_grads_match_repro(name, variant, impl):
    jcfg, tcfg = configs(name, attn_impl=impl, **variant)
    jparams, tparams = weights(jcfg, tcfg)
    tok = tokens(tcfg.vocab, (2, 49), seed=len(name))
    mask = (np.random.default_rng(5).random((2, 48)) < 0.8).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tok[:, :-1]),
              "labels": jnp.asarray(tok[:, 1:]),
              "loss_mask": jnp.asarray(mask)}
    (jloss, jmet), jgrads = jax.value_and_grad(
        j_build(jcfg).train_loss, has_aux=True)(jparams, jbatch)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    loss, metrics, grads = tsteps.loss_and_grads(build_model(tcfg, "cpu"),
                                                 tparams, tbatch)
    assert set(metrics) == {"xent", "aux"}
    if tcfg.moe is None:
        assert float(metrics["aux"]) == 0.0
    else:
        assert float(metrics["aux"]) > 0.0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    assert_leaves_close(by_path(grads), by_path(jgrads), GRAD_TOL)
    for p in tree_leaves_with_path(tparams):
        assert p[1].grad is None and not p[1].requires_grad


def test_softmax_xent_matches_repro():
    from repro.models.api import softmax_xent as j_xent

    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = np.zeros((3, 5), np.int32)
    for m in (None, mask, (rng.random((3, 5)) < 0.5).astype(np.int32)):
        want = float(j_xent(jnp.asarray(logits), jnp.asarray(labels),
                            None if m is None else jnp.asarray(m)))
        got = softmax_xent(torch.from_numpy(logits).to(torch.bfloat16),
                           torch.from_numpy(labels),
                           None if m is None else torch.from_numpy(m))
        want_bf = float(j_xent(jnp.asarray(logits).astype(jnp.bfloat16),
                               jnp.asarray(labels),
                               None if m is None else jnp.asarray(m)))
        np.testing.assert_allclose(float(got), want_bf, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        got32 = softmax_xent(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got32), want, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
    # under autograd the bf16 logits get their gradient in bf16
    x = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    softmax_xent(x, torch.from_numpy(labels)).backward()
    want_g = jax.grad(lambda z: j_xent(z, jnp.asarray(labels)))(
        jnp.asarray(logits).astype(jnp.bfloat16))
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(want_g.astype(jnp.float32)),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,impl,variant,microbatches", [
    ("qwen3-0.6b", "blocked", {}, 1),
    ("qwen3-0.6b", "blocked", {}, 2),
    ("starcoder2-3b", "dense", SLIDING, 2),
    ("granite-moe-3b-a800m", "blocked", {}, 1),
    ("granite-moe-3b-a800m", "dense", {}, 2),
    ("hymba-1.5b", "blocked", {}, 1)])
def test_train_steps_match_repro(name, impl, variant, microbatches):
    jcfg, tcfg = configs(name, attn_impl=impl, **variant)
    jparams, tparams = weights(jcfg, tcfg, seed=1)
    jm, tm = j_build(jcfg), build_model(tcfg, "cpu")
    jopt, topt = joptim.adamw(weight_decay=0.01), toptim.adamw(
        weight_decay=0.01)
    jlr = joptim.linear_warmup_cosine(1e-2, 1, 3)
    tlr = toptim.linear_warmup_cosine(1e-2, 1, 3)
    jstep = jax.jit(jsteps.make_train_step(jm, jopt, jlr,
                                           microbatches=microbatches))
    tstep = tsteps.make_train_step(tm, topt, tlr, microbatches=microbatches)
    jstate = jsteps.TrainState(params=jparams, opt=jopt.init(jparams),
                               step=jnp.zeros((), jnp.int32))
    tstate = tsteps.TrainState(params=tparams, opt=topt.init(tparams),
                               step=torch.zeros((), dtype=torch.int32))
    jsrc = jdata.SyntheticSource(tcfg.vocab, branching=8, seed=1)
    tsrc = tdata.SyntheticSource(tcfg.vocab, branching=8, seed=1)
    spec = tdata.BatchSpec(4, 40, tcfg.vocab)
    for step in range(3):
        jb = jsrc.batch(jdata.BatchSpec(4, 40, tcfg.vocab), step)
        tb = tsrc.batch(spec, step)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in jb.items()})
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                      for k, v in tb.items()})
        assert set(tmet) == {"xent", "aux", "loss", "lr"}
        if tcfg.moe is not None:    # repro reports 0 over microbatches
            assert (float(tmet["aux"]) > 0.0) == (microbatches == 1)
        for k in tmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=LOSS_TOL, atol=LOSS_TOL,
                                       err_msg=k)
    assert int(tstate.step) == 3 and int(tstate.opt.count) == 3
    got, want = by_path(tstate.params), by_path(jstate.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_TOL,
                                   err_msg=k)
    assert_leaves_close(by_path(tstate.opt.mu), by_path(jstate.opt.mu),
                        MOMENT_TOL)


def test_train_step_leaves_its_input_state_and_refuses_a_mesh():
    _, tcfg = configs("qwen3-0.6b")
    model = build_model(tcfg, "cpu")
    opt = toptim.adamw()
    state = tsteps.init_train_state(model, opt,
                                    torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in tree_leaves_with_path(state)}
    batch = tsteps.synth_batch(model, ShapeSpec("t", "train", 16, 2),
                               torch.Generator().manual_seed(1))
    new, metrics = tsteps.make_train_step(model, opt,
                                          toptim.constant(1e-3))(state, batch)
    for k, v in tree_leaves_with_path(state):
        assert torch.equal(v, before[k]), k
        assert v.grad is None
    assert int(new.step) == 1 and bool(torch.isfinite(metrics["loss"]))
    assert not torch.equal(new.params["embed"], state.params["embed"])
    with pytest.raises(NotImplementedError, match="A19"):
        tsteps.make_train_step(model, opt, toptim.constant(1e-3),
                               mesh=object())


def test_train_specs_and_synth_batch():
    jcfg, tcfg = configs("llama3.2-3b")
    shape = ShapeSpec("t", "train", 24, 3)
    model = build_model(tcfg, "cpu")
    specs = model.input_specs(shape)
    jspecs = j_build(jcfg).input_specs(jsteps.ShapeSpec("t", "train", 24, 3))
    assert {k: (s, str(d).removeprefix("torch."))
            for k, (s, d) in specs.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jspecs.items()}
    a = tsteps.synth_batch(model, shape, torch.Generator().manual_seed(2))
    b = tsteps.synth_batch(model, shape, torch.Generator().manual_seed(2))
    assert set(a) == {"tokens", "labels"}
    for k in a:
        assert a[k].shape == (3, 24) and a[k].dtype == torch.int32
        assert torch.equal(a[k], b[k])
        assert 0 <= int(a[k].min()) and int(a[k].max()) < tcfg.vocab
    assert not torch.equal(a["tokens"], a["labels"])


def test_train_state_shapes_match_the_state():
    jcfg, tcfg = configs("qwen3-0.6b")
    model = build_model(tcfg, "cpu")
    opt = toptim.adamw()
    shapes = tsteps.train_state_shapes(model, opt)
    real = tsteps.init_train_state(model, opt,
                                   torch.Generator().manual_seed(0))
    got = dict(tree_leaves_with_path(shapes))
    want = dict(tree_leaves_with_path(real))
    assert list(got) == list(want)
    for k in want:
        assert got[k].device.type == "meta", k
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    # repro's shapes of the same config, leaf by leaf
    jshapes = jsteps.train_state_shapes(j_build(jcfg.replace(
        scan_layers=True)), joptim.adamw())
    jp = jax.tree_util.tree_flatten_with_path(jshapes.params)[0]
    jparams = {".".join(str(getattr(q, "key", q)) for q in path):
               (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in jp}
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tree_leaves_with_path(shapes.params)} == jparams
    # the full-width model, without allocating it
    big = tsteps.train_state_shapes(build_model(get_config("qwen3-0.6b"),
                                                "cpu"), opt)
    n = count_params(big.params)
    assert 5.9e8 < n < 6.0e8
    assert count_params(real.params) == j_count(
        JT.lm_init(jax.random.PRNGKey(0), jcfg.replace(scan_layers=True)))


@pytest.mark.parametrize("name", ["qwen3-0.6b", "llama3.2-3b",
                                  "starcoder2-3b", "qwen3-14b",
                                  "granite-moe-3b-a800m", "hymba-1.5b",
                                  "dbrx-132b", "xlstm-125m",
                                  "whisper-large-v3", "qwen2-vl-72b"])
def test_model_flops_per_token_matches_repro(name):
    from repro.configs import get_config as j_get

    assert model_flops_per_token(get_config(name)) == j_flops(j_get(name))


def test_data_pipeline_is_bitwise(tmp_path):
    for seed, vocab, branching in ((1, 512, 8), (7, 151936, 3)):
        js = jdata.SyntheticSource(vocab, branching=branching, seed=seed)
        ts = tdata.SyntheticSource(vocab, branching=branching, seed=seed)
        assert ts.entropy_floor == js.entropy_floor
        np.testing.assert_array_equal(ts.next_tokens, js.next_tokens)
        for step, host in ((0, 0), (5, 0), (5, 3), (123456, 1)):
            spec = (5, 33, vocab)
            jb = js.batch(jdata.BatchSpec(*spec), step, host)
            tb = ts.batch(tdata.BatchSpec(*spec), step, host)
            assert set(tb) == set(jb) == {"tokens", "labels"}
            for k in jb:
                assert tb[k].dtype == np.int32
                np.testing.assert_array_equal(tb[k], jb[k])
    toks = np.random.default_rng(3).integers(0, 60000, 1001)
    tdata.write_bin_tokens(str(tmp_path / "t.bin"), toks)
    jdata.write_bin_tokens(str(tmp_path / "j.bin"), toks)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin"
                                                 ).read_bytes()
    for host, num_hosts in ((0, 1), (1, 2)):
        jsrc = jdata.BinTokenSource(str(tmp_path / "j.bin"), host=host,
                                    num_hosts=num_hosts)
        tsrc = tdata.BinTokenSource(str(tmp_path / "t.bin"), host=host,
                                    num_hosts=num_hosts)
        for step in (0, 1, 17):
            jb = jsrc.batch(jdata.BatchSpec(3, 20, 60000), step)
            tb = tsrc.batch(tdata.BatchSpec(3, 20, 60000), step)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])


def test_train_state_checkpoint_restores(tmp_path):
    _, tcfg = configs("qwen3-0.6b")
    model = build_model(tcfg, "cpu")
    opt = toptim.adamw()
    step = tsteps.make_train_step(model, opt, toptim.constant(1e-3))
    state = tsteps.init_train_state(model, opt,
                                    torch.Generator().manual_seed(0))
    batch = tsteps.synth_batch(model, ShapeSpec("t", "train", 8, 2),
                               torch.Generator().manual_seed(1))
    state, _ = step(state, batch)
    store = CheckpointStore(str(tmp_path))
    store.save(1, state)
    like = tsteps.init_train_state(model, opt,
                                   torch.Generator().manual_seed(5))
    back = store.restore(1, like)
    assert isinstance(back, tsteps.TrainState)
    assert isinstance(back.opt, toptim.AdamWState)
    got, want = dict(tree_leaves_with_path(back)), dict(
        tree_leaves_with_path(state))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


# --------------------------------------------------------------------- #
# the gradient through the flash-attention kernel
# --------------------------------------------------------------------- #
def qkv(B, H, Hkv, Sq, Skv, D, seed, dtype=torch.float32):
    """q, k, v as (B, S, H, D) tensors seen as (B, H, S, D) views, as the
    model passes its projections."""
    rng = np.random.default_rng(seed)

    def one(h, s):
        return torch.from_numpy(rng.normal(0, 1, (B, s, h, D)).astype(
            np.float32)).to(dtype).transpose(1, 2)

    return one(H, Sq), one(Hkv, Skv), one(Hkv, Skv)


def autograd_of_reference(q, k, v, dout, **masks):
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = mha_reference(*leaves, **masks)
    return torch.autograd.grad(out, leaves, dout)


# (B, H, Hkv, Sq, Skv, D, causal, window)
GRAD_CASES = [
    (2, 4, 2, 40, 40, 16, True, 0),
    (1, 4, 1, 30, 50, 32, True, 7),         # end-aligned, sliding, GQA 4
    (2, 2, 2, 50, 30, 16, True, 0),         # Sq > Skv: rows without keys
    (1, 4, 2, 20, 35, 16, False, 0),
]


@pytest.mark.parametrize("score_bytes", [1 << 30, 4 * 2 * 4 * 50 * 3])
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,window", GRAD_CASES)
def test_plain_grads_match_autograd(monkeypatch, score_bytes, B, H, Hkv,
                                    Sq, Skv, D, causal, window):
    """Whole, and in chunks of a few query rows (``score_bytes`` small)."""
    monkeypatch.setattr(flash_ops, "BACKWARD_SCORE_BYTES", score_bytes)
    q, k, v = qkv(B, H, Hkv, Sq, Skv, D, seed=Sq + Skv)
    dout = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (B, H, Sq, D)).astype(np.float32))
    masks = dict(causal=causal, window=window)
    got = flash_ops.plain_grads(q, k, v, dout, sm_scale=None, **masks)
    want = autograd_of_reference(q, k, v, dout, **masks)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,window", GRAD_CASES)
def test_plain_grads_round_once_in_bf16(monkeypatch, B, H, Hkv, Sq, Skv, D,
                                        causal, window):
    """In chunks, bf16 gradients are the f32 chunks' sums rounded once:
    bitwise those of the same inputs in f32, rounded to bf16."""
    monkeypatch.setattr(flash_ops, "BACKWARD_SCORE_BYTES",
                        4 * B * H * Skv * 3)
    q, k, v = qkv(B, H, Hkv, Sq, Skv, D, seed=Sq + Skv,
                  dtype=torch.bfloat16)
    dout = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (B, H, Sq, D)).astype(np.float32)).to(torch.bfloat16)
    masks = dict(causal=causal, window=window, sm_scale=None)
    got = flash_ops.plain_grads(q, k, v, dout, **masks)
    want = flash_ops.plain_grads(q.float(), k.float(), v.float(),
                                 dout.float(), **masks)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


def test_flash_function_carries_the_gradient(monkeypatch):
    """``_FlashAttentionFn`` with its launch stood in for by the plain
    version (no card here): the output has a ``grad_fn``, the forward
    launches once and the backward not at all, and the gradients are
    autograd's of the plain version."""
    calls = []

    def fake_launch(q, k, v, causal, window, sm_scale):
        calls.append(torch.is_grad_enabled())
        return mha_reference(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale)

    monkeypatch.setattr(flash_ops, "_launch", fake_launch)
    q, k, v = (x.requires_grad_() for x in qkv(2, 4, 2, 24, 24, 16, seed=3))
    out = flash_ops._FlashAttentionFn.apply(q, k, v, True, 5, None)
    assert out.grad_fn is not None and calls == [False]
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert calls == [False]
    want = autograd_of_reference(q, k, v, dout, causal=True, window=5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
