"""The port's LM-policy decode path against the JAX package's, run live
in one process with the same weights (``params_from_jax`` carries the
numpy leaves of ``repro``'s ``LMPolicy.init``).

* ``decode_step``: logits, values and caches.  f32 (``lm-policy``):
  atol 1e-5, rtol 1e-5 (products and sums in another order).  bf16
  (qwen3-0.6b smoke config): logits within 5e-2, caches and values
  within 5e-2, the same dtypes — bf16 rounds at other places in XLA and
  torch (XLA rounds ``silu``'s sigmoid before the product, torch once).
* ``full_forward`` picks the same greedy tokens as ``decode_step``.
* The collect loop over a ``TokenCopy-v0`` pool (``act`` and
  ``act_full``, greedy and sampled): identical actions, ids, dones and
  obs; lane lengths and histories identical, caches within 1e-5.
* ``DecodePool.serve``: identical token lists and step counts for
  fifo/sjf x continuous/static.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.registry as jax_registry  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.core.specs import ArraySpec as JArraySpec  # noqa: E402
from repro.core.specs import EnvSpec as JEnvSpec  # noqa: E402
from repro.rl import policy_lm as jlm  # noqa: E402
from repro.serving import DecodePool as JDecodePool  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.specs import ArraySpec, EnvSpec  # noqa: E402
from repro_torch.models.common import MoEConfig, SSMConfig  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.rl import policy_lm as tlm  # noqa: E402
from repro_torch.serving import DecodePool  # noqa: E402

VOCAB = 512


def specs(vocab: int, ctx: int = 8):
    j = JEnvSpec("lm", JArraySpec((ctx,), jnp.int32, 0, vocab - 1),
                 JArraySpec((), jnp.int32, 0, vocab - 1))
    t = EnvSpec("lm", ArraySpec((ctx,), torch.int32, 0, vocab - 1),
                ArraySpec((), torch.int32, 0, vocab - 1))
    return j, t


def policies(config: str, max_len: int, vocab: int = VOCAB, jspec=None,
             tspec=None, seed: int = 0):
    """(jax policy, port policy, jax params, port params) on one set of
    weights."""
    if jspec is None:
        jspec, tspec = specs(vocab)
    if config == "lm-policy":
        jcfg = jlm.default_policy_config(vocab, max_len)
        tcfg = tlm.default_policy_config(vocab, max_len)
    else:
        jcfg, tcfg = j_smoke(config), get_smoke_config(config)
    jp = jlm.LMPolicy(jspec, jcfg, max_len=max_len)
    tp = tlm.LMPolicy(tspec, tcfg, max_len=max_len, device="cpu")
    jparams = jp.init(jax.random.PRNGKey(seed))
    tparams = tlm.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu")
    return jp, tp, jparams, tparams


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("config,tol", [("lm-policy", 1e-5),
                                        ("qwen3-0.6b", 5e-2)])
def test_decode_step_matches_repro(config, tol):
    T, B = 24, 6
    jp, tp, jparams, tparams = policies(config, T)
    rtol = 1e-5 if config == "lm-policy" else 0.0
    jl, tl = jp.init_lanes(B), tp.init_lanes(B)
    jk, jv, tk, tv = jl.k, jl.v, tl.k, tl.v
    step = jax.jit(jp.decode_step)
    rng = np.random.default_rng(1)
    length = np.array([0, 0, 3, 7, 11, 20], np.int32)
    for _ in range(8):
        tok = rng.integers(0, VOCAB, B).astype(np.int32)
        jlog, jval, jk, jv = step(jparams, jnp.asarray(tok), jk, jv,
                                  jnp.asarray(length))
        tlog, tval, tk, tv = tp.decode_step(
            tparams, torch.from_numpy(tok), tk, tv, torch.from_numpy(length))
        assert tlog.dtype == tp.cfg.compute_dtype == tk.dtype == tval.dtype
        assert str(jlog.dtype) == str(tlog.dtype).removeprefix("torch.")
        for got, want in ((tlog, jlog), (tval, jval), (tk, jk), (tv, jv)):
            np.testing.assert_allclose(f32(got), f32(want), rtol=rtol,
                                       atol=tol)
        length = np.minimum(length + 1, T - 1)


def test_full_forward_picks_the_decode_step_tokens():
    """Greedy tokens of the cached decode equal the no-cache forward's
    over the same history (f32), and match repro's full forward."""
    T, B, S = 16, 5, 12
    jp, tp, jparams, tparams = policies("lm-policy", T)
    hist = np.random.default_rng(2).integers(0, VOCAB, (B, T)).astype(
        np.int32)
    lanes = tp.init_lanes(B)
    k, v = lanes.k, lanes.v
    jfull = jax.jit(jp.full_forward)
    for s in range(S):
        logits, _, k, v = tp.decode_step(
            tparams, torch.from_numpy(hist[:, s]), k, v,
            torch.full((B,), s, dtype=torch.int32))
        full = tp.full_forward(tparams, torch.from_numpy(hist),
                               torch.full((B,), s + 1, dtype=torch.int32))
        want = jfull(jparams, jnp.asarray(hist),
                     jnp.full((B,), s + 1, jnp.int32))
        np.testing.assert_allclose(full.numpy(), f32(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(full.numpy(), logits.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(full.argmax(-1), logits.argmax(-1))


@pytest.mark.parametrize("cached,greedy", [(True, True), (True, False),
                                           (False, False)])
def test_collect_over_token_pool_matches_repro(cached, greedy):
    n, m, steps, T = 8, 4, 12, 16
    jpool = jax_registry.make("TokenCopy-v0", num_envs=n, batch_size=m,
                              obs=False)
    tpool = repro_torch.make("TokenCopy-v0", num_envs=n, batch_size=m,
                             device="cpu")
    jp, tp, jparams, tparams = policies("lm-policy", T, vocab=256,
                                        jspec=jpool.spec, tspec=tpool.spec)
    jcollect = jlm.build_lm_collect_fn(jpool, jp, steps, cached=cached,
                                       greedy=greedy, donate=False)
    tcollect = tlm.build_lm_collect_fn(tpool, tp, steps, cached=cached,
                                       greedy=greedy)
    jps, jts = jpool.reset(jax.random.PRNGKey(5))
    tps, tts = tpool.reset(repro_torch.random.PRNGKey(5))
    jl, tl = jp.init_lanes(n), tp.init_lanes(n)
    for rep in range(2):        # the second rollout starts from the first
        jkey = jax.random.PRNGKey(10 + rep)
        tkey = repro_torch.random.PRNGKey(10 + rep)
        jps, jl, jts, jtraj, jacts = jcollect(jps, jl, jparams, jts, jkey)
        tps, tl, tts, ttraj, tacts = tcollect(tps, tl, tparams, tts, tkey)
        np.testing.assert_array_equal(tacts.numpy(), np.asarray(jacts))
        for f in ("env_id", "done", "obs", "reward"):
            np.testing.assert_array_equal(getattr(ttraj, f).numpy(),
                                          np.asarray(getattr(jtraj, f)),
                                          err_msg=f)
        for f in ("length", "history"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                          np.asarray(getattr(jl, f)))
        for f in ("k", "v"):
            np.testing.assert_allclose(getattr(tl, f).numpy(),
                                       np.asarray(getattr(jl, f)),
                                       rtol=0, atol=1e-5)
    assert tacts.dtype == torch.int32 and tacts.shape == (steps, m)


def serve_case():
    rng = np.random.default_rng(4)
    prompts = [list(rng.integers(0, 64, rng.integers(2, 7)))
               for _ in range(10)]
    budgets = [int(b) for b in rng.choice([2, 8], 10, p=[0.75, 0.25])]
    return prompts, budgets


@pytest.fixture(scope="module")
def serve_pools():
    """schedule -> (repro DecodePool, port policy, both params), built
    once per schedule so repro's jitted programs compile once."""
    pools = {}

    def get(schedule):
        if schedule not in pools:
            jp, tp, jparams, tparams = policies("lm-policy", 15, vocab=64)
            pools[schedule] = (JDecodePool(jp, 4, 8, schedule=schedule), tp,
                               jparams, tparams)
        return pools[schedule]

    return get


@pytest.mark.parametrize("schedule", ["fifo", "sjf"])
@pytest.mark.parametrize("continuous", [True, False])
def test_serve_matches_repro(serve_pools, schedule, continuous):
    prompts, budgets = serve_case()    # prompts <= 6, budgets <= 8: 15
    jpool, tp, jparams, tparams = serve_pools(schedule)
    registry = MetricsRegistry()
    tpool = DecodePool(tp, 4, 8, schedule=schedule, registry=registry)
    want, jstats = jpool.serve(jparams, prompts, continuous=continuous,
                               max_new=budgets)
    got, tstats = tpool.serve(tparams, prompts, continuous=continuous,
                              max_new=budgets)
    assert got == [[int(t) for t in o] for o in want]
    assert [len(o) for o in got] == budgets
    assert (tstats.decode_steps, tstats.total_tokens, tstats.lane_slots) == (
        jstats.decode_steps, jstats.total_tokens, jstats.lane_slots)
    assert tstats.wall_s > 0
    snap = registry.snapshot()
    assert snap["decode_tokens"]["series"][0]["value"] == sum(budgets)


def test_serve_refuses_what_the_cache_cannot_hold():
    _, tp, _, tparams = policies("lm-policy", 8, vocab=64)
    with pytest.raises(ValueError, match="static cache"):
        DecodePool(tp, 2, 4).serve(tparams, [[1, 2, 3, 4, 5]])


def test_params_from_jax_keeps_the_stacked_layout():
    _, tp, jparams, tparams = policies("qwen3-0.6b", 8)
    cfg = tp.cfg
    assert tparams["layers"]["attn"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.q_dim)
    assert tparams["value_head"]["w"].shape == (cfg.d_model, 1)
    np.testing.assert_array_equal(tparams["embed"].numpy(),
                                  np.asarray(jparams["embed"]))
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="n_layers"):
        tlm.params_from_jax(bad, cfg, "cpu")


def test_lm_init_shapes_and_refusals():
    cfg = get_smoke_config("qwen3-0.6b")
    _, tspec = specs(cfg.vocab)
    pol = tlm.LMPolicy(tspec, cfg, max_len=8, device="cpu")
    params = pol.init(torch.Generator().manual_seed(0))
    _, _, jparams, _ = policies("qwen3-0.6b", 8)
    shapes = jax.tree.map(lambda x: tuple(x.shape), jparams)
    tshapes = repro_torch.utils.tree.tree_map(lambda x: tuple(x.shape),
                                              params)
    assert tshapes == shapes
    cast = pol.cast_params(params)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["layers"]["attn_norm"]["scale"].dtype == torch.float32
    # repro's refusal of the MoE and SSM backbones, message and all
    jspec, _ = specs(cfg.vocab)
    for arch in ("granite-moe-3b-a800m", "hymba-1.5b", "dbrx-132b"):
        with pytest.raises(ValueError, match="dense transformer") as want:
            jlm.LMPolicy(jspec, j_smoke(arch))
        with pytest.raises(ValueError, match="dense transformer") as got:
            tlm.LMPolicy(tspec, get_smoke_config(arch), device="cpu")
        assert str(got.value) == str(want.value)
    for bad in (cfg.replace(moe=MoEConfig(4, 2)),
                cfg.replace(ssm=SSMConfig())):
        with pytest.raises(ValueError, match="dense transformer"):
            tlm.LMPolicy(tspec, bad, device="cpu")
    # repro checks the config's moe and ssm parts only: the xLSTM,
    # Whisper and vlm configs construct in both packages alike
    for arch in ("xlstm-125m", "whisper-large-v3", "qwen2-vl-72b"):
        assert jlm.LMPolicy(jspec, j_smoke(arch)).cfg.name == arch
        assert tlm.LMPolicy(tspec, get_smoke_config(arch),
                            device="cpu").cfg.name == arch
