"""The port's model-serving path against the JAX package's, run live in
one process with the same weights (``params_from_jax`` loads the numpy
leaves of ``repro``'s ``lm_init``):

* ``lm_apply``, dense and blocked, on smoke qwen3-0.6b, on smoke
  starcoder2-3b with ``attn_type="sliding", window=8``, and on the MoE
  and hybrid smoke configs (granite-moe-3b-a800m, dbrx-132b: 4 experts
  top-2; hymba-1.5b: window 32 with layer 0 global, SSM chunk 8), the
  MoE aux loss included;
* ``Model.prefill`` + 4 ``decode_step``s: logits and the cache leaves,
  for the exact, int8 and ring (``windowed_cache``) caches and for a
  blocked prefill that fills the whole cache (hymba's past its window:
  the banded branch); a second prompt chunk against a cache that holds
  history, the hybrid's SSM state included;
* ``make_prefill_step`` / ``make_serve_step`` tokens;
* the conformance pin: ``LMPolicy``'s greedy collect picks the tokens
  ``Model.decode_step`` picks replaying each lane alone;
* the cache layout, smoke configs, ``cell_supported`` and
  ``model_flops_per_token`` of every arch against ``repro``'s;
* the vlm family (qwen2-vl-72b): M-RoPE against ``repro``'s
  ``apply_rope`` on (B, S, 3) positions, ``train_loss`` and its
  gradients with a patch prefix, and the blocked prefill of patch
  embeddings and tokens (the flash kernel's plain version here) then
  decode steps at (B, 1, 3) positions against ``repro``'s;
* ``input_specs`` and ``synth_batch`` of the xLSTM, Whisper and vlm
  families at each cell kind.

Everything runs in f32.  ``repro`` runs with ``scan_layers=False``, its
static per-layer windows, as the port does (under ``lax.scan`` its int8
cache ignores the sliding window).  Tolerance 2e-4 on logits and
caches (the products and sums run in another order); int8 cache values
within one quantum, ``len`` exact, tokens identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.api import SHAPES as J_SHAPES  # noqa: E402
from repro.models.api import cell_supported as j_cell_supported  # noqa: E402
from repro.models.api import vlm_patches as j_vlm_patches  # noqa: E402
from repro.models.layers import apply_rope as j_apply_rope  # noqa: E402
from repro.models.common import (  # noqa: E402
    model_flops_per_token as j_flops,
)

import repro_torch  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from _torch_family import assert_leaves_close, leaves  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import SHAPES, build_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.api import cell_supported  # noqa: E402
from repro_torch.models.common import model_flops_per_token  # noqa: E402
from repro_torch.models.api import vlm_patches  # noqa: E402
from repro_torch.models.layers import apply_rope, rope_tables  # noqa: E402
from repro_torch.rl import policy_lm as tlm  # noqa: E402

TOL = 2e-4
SLIDING = dict(attn_type="sliding", window=8)
ARCHS = {"qwen3": ("qwen3-0.6b", {}), "starcoder2-sliding":
         ("starcoder2-3b", SLIDING),
         "granite-moe": ("granite-moe-3b-a800m", {}),
         "hymba": ("hymba-1.5b", {}), "dbrx": ("dbrx-132b", {})}


def configs(arch: str, **variant):
    """(repro config, port config), f32 compute, ``variant`` applied."""
    name, over = ARCHS[arch]
    jcfg = j_smoke(name).replace(compute_dtype=jnp.float32,
                                 scan_layers=False, **over, **variant)
    tcfg = get_smoke_config(name).replace(compute_dtype=torch.float32,
                                          **over, **variant)
    return jcfg, tcfg


def weights(jcfg, tcfg, seed: int = 0):
    """repro's ``lm_init`` weights (stacked layers) and the port's copy."""
    jparams = JT.lm_init(jax.random.PRNGKey(seed),
                         jcfg.replace(scan_layers=True))
    tparams = tlm.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu")
    return jparams, tparams


def tokens(vocab: int, shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_caches_match(tc: dict, jc: dict) -> None:
    assert set(tc) == set(jc)
    for name in jc:
        got, want = tc[name], jc[name]
        assert tuple(got.shape) == tuple(want.shape), name
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), name
        if name == "len":
            assert int(got) == int(want)
        elif got.dtype == torch.int8:       # one quantum at a rounding tie
            np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=1,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(f32(got), f32(want), rtol=TOL,
                                       atol=TOL, err_msg=name)


@pytest.mark.parametrize("impl", ["dense", "blocked"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_apply_matches_repro(arch, impl):
    jcfg, tcfg = configs(arch, attn_impl=impl)
    jparams, tparams = weights(jcfg, tcfg)
    tok = tokens(tcfg.vocab, (2, 40))
    want, jcache, jaux = JT.lm_apply(jparams, jnp.asarray(tok), jcfg)
    got, tcache, aux = TT.lm_apply(tparams, torch.from_numpy(tok), tcfg)
    assert tcache is None and jcache is None
    assert aux.dtype == torch.float32 and aux.shape == ()
    if tcfg.moe is None:
        assert float(aux) == 0.0
    else:
        assert float(aux) > 0.0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL,
                                   atol=TOL)
    assert got.shape == (2, 40, tcfg.vocab)
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL, atol=TOL)


# (arch, config variant, prompt length, cache length)
SERVE_CASES = [
    ("qwen3", {}, 12, 16),
    ("qwen3", dict(kv_cache_dtype="int8"), 12, 16),
    ("qwen3", dict(attn_impl="blocked"), 12, 12),       # flash prefill
    ("qwen3", dict(attn_impl="blocked"), 12, 16),       # dense: S < L
    ("starcoder2-sliding", {}, 12, 16),
    ("starcoder2-sliding", dict(kv_cache_dtype="int8"), 12, 16),
    ("starcoder2-sliding", dict(windowed_cache=True), 6, 16),  # L = 8
    ("starcoder2-sliding", dict(attn_impl="blocked"), 12, 12),  # banded
    ("granite-moe", {}, 12, 16),
    ("granite-moe", dict(kv_cache_dtype="int8"), 12, 16),
    ("granite-moe", dict(attn_impl="blocked"), 12, 12),
    ("dbrx", {}, 12, 16),
    # hymba's prompts are whole SSM chunks of 8
    ("hymba", {}, 16, 20),
    ("hymba", dict(kv_cache_dtype="int8"), 16, 20),
    ("hymba", dict(attn_impl="blocked"), 40, 40),   # banded past window 32
]


@pytest.mark.parametrize("arch,variant,S,max_len", SERVE_CASES)
def test_prefill_and_decode_match_repro(arch, variant, S, max_len):
    jcfg, tcfg = configs(arch, **variant)
    jparams, tparams = weights(jcfg, tcfg)
    jm, tm = j_build(jcfg), build_model(tcfg, "cpu")
    tok = tokens(tcfg.vocab, (2, S + 4))
    jlog, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tok[:, :S])},
                          max_len=max_len)
    tlog, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(tok[:, :S])},
                          max_len=max_len)
    for t in range(S, S + 5):
        assert tlog.shape == (2, tcfg.vocab)
        np.testing.assert_allclose(f32(tlog), f32(jlog), rtol=TOL, atol=TOL)
        assert_caches_match(tc, jc)
        if t == S + 4:
            break
        jlog, jc = jm.decode_step(jparams, jnp.asarray(tok[:, t:t + 1]), jc)
        tlog, tc = tm.decode_step(tparams, torch.from_numpy(tok[:, t:t + 1]),
                                  tc)


@pytest.mark.parametrize("arch,variant,first,second", [
    ("qwen3", {}, 6, 11), ("starcoder2-sliding", {}, 6, 11),
    ("starcoder2-sliding", dict(kv_cache_dtype="int8"), 6, 11),
    ("granite-moe", {}, 6, 11), ("hymba", {}, 8, 16)])
def test_chunked_prefill_matches_repro(arch, variant, first, second):
    """A second prompt chunk against a cache that holds history: S > 1
    tokens written at ``len``, causal over the history (hymba's SSM
    scan starting from the state the first chunk left)."""
    jcfg, tcfg = configs(arch, **variant)
    jparams, tparams = weights(jcfg, tcfg, seed=3)
    jm, tm = j_build(jcfg), build_model(tcfg, "cpu")
    end = first + second
    tok = tokens(tcfg.vocab, (2, end), seed=6)
    _, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tok[:, :first])},
                       max_len=end + 3)
    _, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(tok[:, :first])},
                       max_len=end + 3)
    jlog, jc, _ = JT.lm_apply(jparams, jnp.asarray(tok[:, first:end]), jcfg,
                              cache=jc)
    tlog, tc, _ = TT.lm_apply(tparams, torch.from_numpy(tok[:, first:end]),
                              tcfg, cache=tc)
    np.testing.assert_allclose(f32(tlog), f32(jlog), rtol=TOL, atol=TOL)
    assert_caches_match(tc, jc)


def test_ring_cache_decode_matches_repro():
    """A sliding config with ``windowed_cache`` decoding against a cache
    longer than its window writes slot ``len % L`` (the ring branch)."""
    jcfg, tcfg = configs("starcoder2-sliding", windowed_cache=True)
    jparams, tparams = weights(jcfg, tcfg)
    plain_j = j_build(jcfg.replace(windowed_cache=False))
    plain_t = build_model(tcfg.replace(windowed_cache=False), "cpu")
    jm, tm = j_build(jcfg), build_model(tcfg, "cpu")
    tok = tokens(tcfg.vocab, (2, 20), seed=4)
    _, jc = plain_j.prefill(jparams, {"tokens": jnp.asarray(tok[:, :10])},
                            max_len=12)
    _, tc = plain_t.prefill(tparams, {"tokens": torch.from_numpy(tok[:, :10])},
                            max_len=12)
    for t in range(10, 18):                 # wraps past L = 12
        jlog, jc = jm.decode_step(jparams, jnp.asarray(tok[:, t:t + 1]), jc)
        tlog, tc = tm.decode_step(tparams, torch.from_numpy(tok[:, t:t + 1]),
                                  tc)
        np.testing.assert_allclose(f32(tlog), f32(jlog), rtol=TOL, atol=TOL)
        assert_caches_match(tc, jc)
    with pytest.raises(ValueError, match="single-token"):
        tm.decode_step(tparams, torch.from_numpy(tok[:, :2]), tc)


@pytest.mark.parametrize("arch,impl", [("qwen3", "blocked"),
                                       ("starcoder2-sliding", "dense")])
def test_serving_steps_match_repro(arch, impl):
    jcfg, tcfg = configs(arch, attn_impl=impl)
    jparams, tparams = weights(jcfg, tcfg, seed=2)
    S, L = 10, 10 if impl == "blocked" else 16
    jm, tm = j_build(jcfg), build_model(tcfg, "cpu")
    jprefill = jsteps.make_prefill_step(jm, L)
    jserve = jax.jit(jsteps.make_serve_step(jm))
    tprefill = tsteps.make_prefill_step(tm, L)
    tserve = tsteps.make_serve_step(tm)
    tok = tokens(tcfg.vocab, (3, S), seed=5)
    jnext, jc = jprefill(jparams, {"tokens": jnp.asarray(tok)})
    tnext, tc = tprefill(tparams, {"tokens": torch.from_numpy(tok)})
    for _ in range(5):
        assert tnext.dtype == torch.int32
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
        jnext, jc = jserve(jparams, jc, {"tokens": jnext[:, None]})
        tnext, tc = tserve(tparams, tc, {"tokens": tnext[:, None]})
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
    assert int(tc["len"]) == int(jc["len"]) == S + 5


def test_policy_decode_matches_model_decode():
    """The conformance pin: per-lane greedy tokens of the policy's cached
    collect (ragged lengths, ``decode_attention``) equal those of
    ``Model.decode_step`` replaying each lane alone from its own
    cache."""
    N, steps, max_len = 4, 20, 16
    pool = repro_torch.make("TokenCopy-v0", num_envs=N, vocab=32, ep_len=6,
                            ctx_len=8, device="cpu")
    policy = tlm.LMPolicy(pool.spec,
                          cfg=tlm.default_policy_config(32, max_len),
                          max_len=max_len, device="cpu")
    params = policy.init(torch.Generator().manual_seed(3))
    collect = tlm.build_lm_collect_fn(pool, policy, steps, cached=True,
                                      greedy=True)
    ps, ts = pool.reset(repro_torch.random.PRNGKey(4))
    _, _, _, traj, acts = collect(ps, policy.init_lanes(N), params, ts,
                                  repro_torch.random.PRNGKey(5))
    ids = traj.env_id.long().numpy()
    obs = np.zeros_like(traj.obs.numpy())
    done = np.zeros_like(traj.done.numpy())
    acts_lane = np.zeros_like(acts.numpy())
    for t in range(steps):
        obs[t, ids[t]] = traj.obs.numpy()[t]
        done[t, ids[t]] = traj.done.numpy()[t]
        acts_lane[t, ids[t]] = acts.numpy()[t]

    model = build_model(policy.cfg, "cpu")
    for lane in range(N):
        cache = model.init_cache(1, max_len)
        for t in range(steps):
            if done[t, lane]:
                cache = model.init_cache(1, max_len)
            tok = torch.tensor([[obs[t, lane, policy.obs_slot]]],
                               dtype=torch.int32)
            logits, cache = model.decode_step(params, tok, cache)
            assert int(logits[0].argmax()) == int(acts_lane[t, lane]), (
                f"lane {lane} step {t}")


def test_init_cache_matches_repro_layout():
    for arch, variant in (("qwen3", {}), ("qwen3", dict(kv_cache_dtype=
                                                       "int8")),
                          ("starcoder2-sliding", dict(windowed_cache=True)),
                          ("granite-moe", {}), ("hymba", {}),
                          ("hymba", dict(kv_cache_dtype="int8",
                                         windowed_cache=True))):
        jcfg, tcfg = configs(arch, **variant)
        jc = j_build(jcfg).init_cache(3, 20)
        tc = build_model(tcfg, "cpu").init_cache(3, 20)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()} \
            == {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in tc.items()}
        assert all(not bool(v.any()) for v in tc.values())


CONFIG_FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                 "d_ff", "vocab", "hd", "qk_norm", "mlp_type", "norm_type",
                 "rope_theta", "rope_type", "mrope_sections", "attn_type",
                 "window", "global_attn_layers", "enc_layers", "enc_seq",
                 "frontend", "tie_embeddings", "max_seq", "windowed_cache",
                 "attn_impl", "kv_cache_dtype", "sub_quadratic")


def assert_configs_equal(tcfg, jcfg, name: str) -> None:
    for field in CONFIG_FIELDS:
        assert getattr(tcfg, field) == getattr(jcfg, field), (name, field)
    for part in ("moe", "ssm", "xlstm"):
        t, j = getattr(tcfg, part), getattr(jcfg, part)
        assert (t is None) == (j is None), (name, part)
        if t is not None:
            assert dataclasses.asdict(t) == dataclasses.asdict(j), (name,
                                                                   part)


def test_smoke_configs_match_repro():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for name in tconfigs.list_archs():
        assert_configs_equal(get_smoke_config(name), j_smoke(name), name)
        assert_configs_equal(tconfigs.get_config(name),
                             jconfigs.get_config(name), name)


def test_cell_supported_and_flops_match_repro():
    """Every arch x every shape cell, at full width and smoke size:
    ``long_500k`` only for hymba (sliding attention + SSM) and the
    xLSTM; whisper's FLOPs with its encoder and cross-attention terms."""
    for name in tconfigs.list_archs():
        for tcfg, jcfg in ((tconfigs.get_config(name),
                            jconfigs.get_config(name)),
                           (get_smoke_config(name), j_smoke(name))):
            for cell in SHAPES:
                assert cell_supported(tcfg, SHAPES[cell]) == \
                    j_cell_supported(jcfg, J_SHAPES[cell]), (name, cell)
            assert model_flops_per_token(tcfg) == j_flops(jcfg), name
    for name in ("hymba-1.5b", "xlstm-125m"):
        assert cell_supported(tconfigs.get_config(name),
                              SHAPES["long_500k"]) == (True, "")
    whisper = tconfigs.get_config("whisper-large-v3")
    assert model_flops_per_token(whisper) > model_flops_per_token(
        whisper.replace(enc_layers=0))


def test_shapes_and_synth_batch():
    assert {k: (s.kind, s.seq_len, s.global_batch) for k, s in
            SHAPES.items()} == {k: (s.kind, s.seq_len, s.global_batch)
                                for k, s in J_SHAPES.items()}
    _, tcfg = configs("qwen3")
    model = build_model(tcfg, "cpu")
    assert cell_supported(tcfg, SHAPES["prefill_32k"]) == (True, "")
    assert not cell_supported(tcfg, SHAPES["long_500k"])[0]
    shape = tsteps.ShapeSpec("p", "prefill", 24, 3)
    a = tsteps.synth_batch(model, shape, torch.Generator().manual_seed(0))
    b = tsteps.synth_batch(model, shape, torch.Generator().manual_seed(0))
    assert set(a) == {"tokens"} and a["tokens"].shape == (3, 24)
    assert a["tokens"].dtype == torch.int32 and torch.equal(a["tokens"],
                                                            b["tokens"])
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < tcfg.vocab
    d = tsteps.synth_batch(model, SHAPES["decode_32k"],
                           torch.Generator().manual_seed(0))
    assert d["tokens"].shape == (128, 1)
    t = tsteps.synth_batch(model, SHAPES["train_4k"],
                           torch.Generator().manual_seed(0))
    assert set(t) == {"tokens", "labels"}
    assert t["tokens"].shape == t["labels"].shape == (256, 4096)
    assert t["labels"].dtype == torch.int32


def test_what_is_not_ported_raises(monkeypatch):
    """Every arch of the registry builds and draws its smoke weights on
    the CPU, and every family, the MoE, hybrid, xLSTM and Whisper ones
    included, builds its sharded serving steps (they run on gloo ranks
    in tests/test_torch_sharded_steps.py); what the port refuses still
    raises: a prompt longer than the cache, a model on a missing
    card."""
    _, tcfg = configs("qwen3")
    for name in tconfigs.list_archs():
        model = build_model(get_smoke_config(name), "cpu")
        assert model.init(torch.Generator().manual_seed(0))
    for name in ("granite-moe-3b-a800m", "hymba-1.5b", "xlstm-125m",
                 "whisper-large-v3"):
        family = build_model(get_smoke_config(name), "cpu")
        assert callable(tsteps.make_prefill_step(family, 8, mesh=object()))
        assert callable(tsteps.make_serve_step(family, mesh=object()))
    model = build_model(tcfg, "cpu")
    with pytest.raises(ValueError, match="do not fit"):
        model.prefill(model.init(torch.Generator().manual_seed(0)),
                      {"tokens": torch.zeros((1, 9), dtype=torch.int32)},
                      max_len=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tcfg)


# --------------------------------------------------------------------- #
# the vlm family: M-RoPE and a patch prefix (qwen2-vl-72b)
# --------------------------------------------------------------------- #
VLM = "qwen2-vl-72b"


def vlm_configs(**variant):
    jcfg = j_smoke(VLM).replace(compute_dtype=jnp.float32,
                                scan_layers=False, **variant)
    tcfg = get_smoke_config(VLM).replace(compute_dtype=torch.float32,
                                         **variant)
    return jcfg, tcfg


def mrope_positions(B: int, grid: int, text: int) -> np.ndarray:
    """Qwen2-VL's position ids (B, grid^2 + text, 3): the patches at
    (0, row, col), then text from the grid's largest id + 1 with t = h
    = w."""
    r, c = np.divmod(np.arange(grid * grid), grid)
    patches = np.stack([np.zeros_like(r), r, c], -1)
    t = grid + np.arange(text)
    pos = np.concatenate([patches, np.stack([t, t, t], -1)])
    return np.broadcast_to(pos, (B,) + pos.shape).astype(np.int32).copy()


def vlm_batch(tcfg, B: int, grid: int, text: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"patch_embeds": (rng.normal(0, 0.02, (B, grid * grid,
                                                  tcfg.d_model))
                             .astype(np.float32)),
            "tokens": tokens(tcfg.vocab, (B, text), seed),
            "positions": mrope_positions(B, grid, text)}


@pytest.mark.parametrize("rope_type", ["mrope", "none"])
def test_rope_variants_match_repro(rope_type):
    jcfg, tcfg = vlm_configs(rope_type=rope_type)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 11, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 11, 3)).astype(np.int32)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    tables = rope_tables(torch.from_numpy(pos), tcfg)
    assert (tables is None) == (rope_type == "none")
    got = apply_rope(torch.from_numpy(x), tables, tcfg)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-6, atol=1e-6)
    if rope_type == "mrope":
        with pytest.raises(ValueError, match=r"\(B, S, 3\)"):
            rope_tables(torch.from_numpy(pos[..., 0]), tcfg)


@pytest.mark.parametrize("impl", ["dense", "blocked"])
def test_vlm_train_loss_and_grads_match_repro(impl):
    """The loss over the text region after a prefix of patch embeddings;
    the gradients in every weight."""
    jcfg, tcfg = vlm_configs(attn_impl=impl)
    jparams, tparams = weights(jcfg, tcfg, seed=4)
    b = vlm_batch(tcfg, 2, 2, 13, seed=4)
    jbatch = {"tokens": jnp.asarray(b["tokens"][:, :-1]),
              "labels": jnp.asarray(b["tokens"][:, 1:]),
              "patch_embeds": jnp.asarray(b["patch_embeds"]),
              "positions": jnp.asarray(b["positions"][:, :-1])}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        j_build(jcfg).train_loss, has_aux=True))(jparams, jbatch)
    loss, metrics, tg = tsteps.loss_and_grads(
        build_model(tcfg, "cpu"), tparams,
        {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()})
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert_leaves_close(leaves(tg), leaves(jg), 2e-4)


def test_vlm_blocked_prefill_and_decode_match_repro():
    """Patch embeddings and tokens fill the cache through the blocked
    branch (one flash call a layer), then decode steps at (B, 1, 3)
    positions: logits and caches against ``repro``'s."""
    jcfg, tcfg = vlm_configs(attn_impl="blocked")
    jparams, tparams = weights(jcfg, tcfg, seed=5)
    b = vlm_batch(tcfg, 2, 3, 12, seed=5)       # 9 patches + 12 tokens
    S = 9 + 8
    pre = {"patch_embeds": b["patch_embeds"], "tokens": b["tokens"][:, :8],
           "positions": b["positions"][:, :S]}
    jm, tm = j_build(jcfg), build_model(tcfg, "cpu")
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step)
    jpre = {k: jnp.asarray(v) for k, v in pre.items()}
    tpre = {k: torch.from_numpy(v) for k, v in pre.items()}
    jlog, jc = jprefill(jparams, jpre, S)
    tlog, tc = tm.prefill(tparams, tpre, max_len=S)
    np.testing.assert_allclose(f32(tlog), f32(jlog), rtol=TOL, atol=TOL)
    assert_caches_match(tc, jc)
    # the decode steps against a cache with room for them
    jlog, jc = jprefill(jparams, jpre, S + 4)
    tlog, tc = tm.prefill(tparams, tpre, max_len=S + 4)
    for t in range(8, 12):
        tok, pos = b["tokens"][:, t:t + 1], b["positions"][:, 9 + t:10 + t]
        jlog, jc = jdecode(jparams, jnp.asarray(tok), jc,
                           positions=jnp.asarray(pos))
        tlog, tc = tm.decode_step(tparams, torch.from_numpy(tok), tc,
                                  positions=torch.from_numpy(pos))
        np.testing.assert_allclose(f32(tlog), f32(jlog), rtol=TOL, atol=TOL)
        assert_caches_match(tc, jc)


@pytest.mark.parametrize("name", ["xlstm-125m", "whisper-large-v3",
                                  "qwen2-vl-72b"])
def test_input_specs_and_synth_batch_per_family(name):
    """``input_specs`` of a train, a prefill and a decode cell equal
    ``repro``'s; ``synth_batch`` draws them by ``repro``'s rules: tokens
    and labels in [0, vocab), M-RoPE positions in [0, 4), frames and
    patch embeddings normals x 0.02 in the compute dtype."""
    tcfg = get_smoke_config(name)
    model, jmodel = build_model(tcfg, "cpu"), j_build(j_smoke(name))
    assert vlm_patches(64) == j_vlm_patches(64) == 16
    assert vlm_patches(1 << 20) == j_vlm_patches(1 << 20) == 1024
    for kind, S, B in (("train", 64, 3), ("prefill", 64, 2),
                       ("decode", 64, 4)):
        specs = model.input_specs(tsteps.ShapeSpec("c", kind, S, B))
        jspecs = jmodel.input_specs(J_SHAPES["train_4k"].__class__(
            "c", kind, S, B))
        assert {k: (shp, str(d).removeprefix("torch."))
                for k, (shp, d) in specs.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in jspecs.items()}
        batch = tsteps.synth_batch(model, tsteps.ShapeSpec("c", kind, S, B),
                                   torch.Generator().manual_seed(0))
        for k, (shp, dtype) in specs.items():
            x = batch[k]
            assert tuple(x.shape) == shp and x.dtype == dtype, k
            if dtype.is_floating_point:
                assert 0.01 < float(x.float().std()) < 0.03, k
            else:
                hi = tcfg.vocab if k in ("tokens", "labels") else 4
                assert 0 <= int(x.min()) and int(x.max()) < hi, k
