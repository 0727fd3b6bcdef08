"""Rematerialisation (``models/remat.py``, ``ModelConfig.remat``) against
``repro``'s ``_remat``, run live in one process with the same weights
(``params_from_jax``):

* the smoke qwen3-0.6b, granite-moe-3b-a800m, hymba-1.5b, qwen2-vl-72b
  and whisper-large-v3 (f32, blocked attention where the family has
  it): at ``none``, ``full`` and ``dots`` the port's loss and gradients
  equal the port's at ``none`` bit for bit, and ``repro``'s
  ``jax.value_and_grad`` at the same ``remat`` within 1e-5 (loss) and
  2e-4 of each gradient leaf's largest entry; a checkpoint a layer at
  ``full`` and ``dots`` (the encoder's and the decoder's for Whisper),
  none at ``none``;
* the dry run's tracker (``launch/dryrun.py::live_bytes_mode``) on meta
  tensors orders a train step's peak ``full`` < ``dots`` < ``none``;
* a layer that writes a cache runs once, never checkpointed, with grad
  on and weights that require it (the decoder stack's and Whisper's);
* one qwen3-0.6b train step at bf16 and ``full``: the loss, the
  gradients and the parameters after an AdamW step within 3e-2 of each
  leaf's largest magnitude of ``repro``'s at bf16 and ``full``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.optim as joptim  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402

from _torch_family import (  # noqa: E402
    assert_leaves_close,
    configs,
    leaves,
    normal,
    tokens,
    weights,
)
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import ShapeSpec, build_model  # noqa: E402
from repro_torch.models import remat, whisper  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ARCHS = ["qwen3-0.6b", "granite-moe-3b-a800m", "hymba-1.5b", "qwen2-vl-72b",
         "whisper-large-v3"]
REMATS = ["none", "full", "dots"]
B, S = 2, 16
PATCHES = 4


def batch(tcfg, seed: int) -> dict:
    """A train batch of numpy inputs: S tokens (after ``PATCHES`` patch
    embeddings and with M-RoPE positions for a vlm, beside frames for
    Whisper)."""
    tok = tokens(tcfg.vocab, (B, S + 1), seed)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if tcfg.family == "encdec":
        out["frames"] = normal((B, tcfg.enc_seq, tcfg.d_model), seed, 0.02)
    if tcfg.family == "vlm":
        out["patch_embeds"] = normal((B, PATCHES, tcfg.d_model), seed, 0.02)
        pos = np.arange(PATCHES + S, dtype=np.int32)
        out["positions"] = np.broadcast_to(
            np.stack([pos, pos, pos], -1), (B, PATCHES + S, 3)).copy()
    return out


@pytest.fixture(scope="module")
def checkpoints(request):
    """The checkpoint calls of ``remat_call``, counted."""
    calls = []
    real = remat._checkpoint.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)

    remat._checkpoint.checkpoint = counted
    request.addfinalizer(lambda: setattr(remat._checkpoint, "checkpoint",
                                         real))
    return calls


@pytest.fixture(scope="module")
def port_none():
    """The port's loss and gradients at ``none``, by arch."""
    return {}


def blocked(arch: str) -> dict:
    return {} if arch == "whisper-large-v3" else {"attn_impl": "blocked"}


@pytest.mark.parametrize("remat_kind", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_at_each_remat(arch, remat_kind, checkpoints,
                                      port_none):
    jcfg, tcfg = configs(arch, remat=remat_kind, **blocked(arch))
    jparams, tparams = weights(jcfg, tcfg, seed=len(arch))
    data = batch(tcfg, seed=len(arch))
    tb = {k: torch.from_numpy(v) for k, v in data.items()}
    del checkpoints[:]
    loss, _, grads = tsteps.loss_and_grads(build_model(tcfg, "cpu"),
                                           tparams, tb)
    layers = tcfg.n_layers + tcfg.enc_layers
    assert len(checkpoints) == (0 if remat_kind == "none" else layers)
    if remat_kind == "none":
        port_none[arch] = (loss, leaves(grads))
    if arch not in port_none:       # a worker that runs this case alone
        none = tcfg.replace(remat="none")
        got = tsteps.loss_and_grads(build_model(none, "cpu"), tparams, tb)
        port_none[arch] = (got[0], leaves(got[2]))
    want_loss, want_grads = port_none[arch]
    assert torch.equal(loss, want_loss)
    got = leaves(grads)
    for k, g in want_grads.items():
        np.testing.assert_array_equal(got[k], g, err_msg=k)

    (jloss, _), jg = jax.jit(jax.value_and_grad(
        j_build(jcfg).train_loss, has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in data.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert_leaves_close(got, leaves(jg), 2e-4)


def meta_peak(arch: str, remat_kind: str) -> int:
    """The tracker's peak of a train step's own bytes on meta tensors:
    4 layers, B=4, S=128."""
    cfg = get_smoke_config(arch).replace(remat=remat_kind, n_layers=4,
                                         attn_impl="blocked")
    model = build_model(cfg, "meta")
    params = model.init(torch.Generator())
    shape = ShapeSpec("t", "train", 128, 4)
    data = {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in model.input_specs(shape).items()}
    live = dryrun.live_bytes_mode()
    with live:
        tsteps.loss_and_grads(model, params, data)
    return live.peak


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-large-v3"])
def test_meta_peaks_order_full_dots_none(arch):
    peaks = {k: meta_peak(arch, k) for k in REMATS}
    assert peaks["full"] < peaks["dots"] < peaks["none"], peaks


def test_cache_writes_under_grad_are_never_checkpointed(checkpoints):
    """The decoder stack's prefill into a cache and a decode step, and
    Whisper's, with grad on and weights that require it: no layer that
    writes the cache is checkpointed (Whisper's encoder, which writes
    none, is), and the cache holds what a run without grad wrote."""
    for arch in ("qwen3-0.6b", "whisper-large-v3"):
        cfg = get_smoke_config(arch).replace(remat="full",
                                             compute_dtype=torch.float32)
        model = build_model(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        for p in tree_leaves(params):
            p.requires_grad_()
        data = {k: torch.from_numpy(v) for k, v in
                batch(cfg, seed=3).items() if k in ("tokens", "frames")}
        del checkpoints[:]
        with torch.enable_grad():
            _, cache = model.prefill(params, data, max_len=S + 2)
            _, cache = model.decode_step(params, data["tokens"][:, :1],
                                         cache)
        assert checkpoints == [whisper._encoder_layer] * cfg.enc_layers, arch
        with torch.no_grad():
            _, want = model.prefill(params, data, max_len=S + 2)
            _, want = model.decode_step(params, data["tokens"][:, :1], want)
        for k in want:
            torch.testing.assert_close(cache[k].detach(), want[k], rtol=0,
                                       atol=0, msg=k)


def test_bf16_train_step_at_full_matches_repro():
    """One qwen3-0.6b train step (blocked, bf16 compute, ``full``) from
    ``repro``'s weights on the same batch: the loss, every gradient leaf
    and every parameter after the AdamW step within 3e-2 of the leaf's
    largest magnitude of ``repro``'s."""
    jcfg, tcfg = configs("qwen3-0.6b", attn_impl="blocked", remat="full")
    jcfg = jcfg.replace(compute_dtype=jnp.bfloat16)
    tcfg = tcfg.replace(compute_dtype=torch.bfloat16)
    jparams, tparams = weights(jcfg, tcfg, seed=2)
    data = batch(tcfg, seed=2)
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    tb = {k: torch.from_numpy(v) for k, v in data.items()}
    jm, tm = j_build(jcfg), build_model(tcfg, "cpu")
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.train_loss,
                                                has_aux=True))(jparams, jb)
    loss, _, grads = tsteps.loss_and_grads(tm, tparams, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=3e-2)
    assert_leaves_close(leaves(grads), leaves(jg), 3e-2)

    jopt, topt = joptim.adamw(), toptim.adamw()
    jstate = jsteps.TrainState(params=jparams, opt=jopt.init(jparams),
                               step=jnp.zeros((), jnp.int32))
    jstate, _ = jax.jit(jsteps.make_train_step(
        jm, jopt, joptim.constant(1e-3)))(jstate, jb)
    tstate = tsteps.TrainState(params=tparams, opt=topt.init(tparams),
                               step=torch.zeros((), dtype=torch.int32))
    tstate, _ = tsteps.make_train_step(tm, topt, toptim.constant(1e-3))(
        tstate, tb)
    assert_leaves_close(leaves(tstate.params), leaves(jstate.params), 3e-2)


@pytest.mark.parametrize("remat_kind", ["full", "dots"])
def test_remat_on_a_mesh_of_dtensors(remat_kind):
    """The smoke qwen3 (blocked) on a (1, 2) mesh of a fake group, on meta
    tensors, forward and backward under DTensor's implicit replication
    as the train step runs them: the recompute (selective checkpointing
    at ``dots``) runs on DTensors and under the replication of the
    backward's caller, every gradient comes back in its parameter's
    shape, and the flag is as the scope left it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import (
        BASELINE_RULES,
        make_shard_fn,
        param_shardings,
        place,
    )
    from repro_torch.launch.steps import batch_shardings

    cfg = get_smoke_config("qwen3-0.6b").replace(attn_impl="blocked",
                                                 remat=remat_kind)
    assert not dist.is_initialized()
    dryrun.join_fake_group(2)
    try:
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        model = build_model(cfg, "meta")
        params = model.init(torch.Generator())
        params = place(params, param_shardings(mesh, params, BASELINE_RULES),
                       mesh)
        for p in tree_leaves(params):
            p.requires_grad_()
        data = {k: torch.empty((2, 16), dtype=torch.int32, device="meta")
                for k in ("tokens", "labels")}
        data = place(data, batch_shardings(mesh, data, BASELINE_RULES), mesh)
        with implicit_replication():
            loss, _ = model.train_loss(params, data,
                                       make_shard_fn(mesh, BASELINE_RULES))
            grads = torch.autograd.grad(loss, tree_leaves(params))
            assert DTensor._op_dispatcher._allow_implicit_replication
        assert not DTensor._op_dispatcher._allow_implicit_replication
    finally:
        dist.destroy_process_group()
    assert [g.shape for g in grads] == [p.shape for p in tree_leaves(params)]
