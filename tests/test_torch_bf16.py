"""bf16 parity: the port against ``repro`` both run at bf16 compute (the
smoke configs' own ``compute_dtype``, f32 parameters), on the CPU, with
the same weights (``params_from_jax``) and inputs:

* granite-moe-3b-a800m's routing from bf16 hidden states: slots and
  keep bitwise, on random states and on states and a router on a
  coarse grid where whole sets of experts tie exactly in f32, so the
  tie order decides which lanes a full expert drops; ``apply_moe``'s
  output; the model's prefill and decode steps;
* hymba-1.5b's prefill (attention + SSM heads) and decode steps;
* whisper-large-v3's prefill (its frames encoded, the cross K/V built)
  and decode steps, the bf16 cache leaves included;
* qwen2-vl-72b's M-RoPE prefill of patch embeddings and tokens, then
  decode steps at (B, 1, 3) positions.

Tolerances, stated once: bf16 keeps 8 bits, and XLA and PyTorch round
intermediate results at other points (XLA widens bf16 elementwise
fusions to f32 and rounds once at their end), so values part by a few
bf16 ulps a layer.  Logits, cache leaves and MoE outputs are held within
``MAX_TOL`` = 3e-2 of the largest magnitude of ``repro``'s (a few ulps
of bf16 at the top of the range) and on average within ``MEAN_TOL`` =
4e-3 of it; measured here at the smoke sizes the largest is 1.8e-2
(hymba's decode) and the mean at most 3.0e-3.  Routing decisions and
cache lengths are exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import moe as JM  # noqa: E402

from _torch_family import f32, tokens  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.rl import policy_lm as tlm  # noqa: E402
from test_torch_models import vlm_batch  # noqa: E402

MAX_TOL, MEAN_TOL = 3e-2, 4e-3


def configs(name: str):
    """(repro config, port config) at the smoke size, bf16 compute."""
    jcfg = j_smoke(name).replace(scan_layers=False)
    tcfg = get_smoke_config(name)
    assert jcfg.compute_dtype == jnp.bfloat16
    assert tcfg.compute_dtype == torch.bfloat16
    return jcfg, tcfg


def weights(jcfg, tcfg, seed: int = 0):
    jparams = j_build(jcfg.replace(scan_layers=True)).init(
        jax.random.PRNGKey(seed))
    return jparams, tlm.params_from_jax(jax.tree.map(np.asarray, jparams),
                                        tcfg, "cpu")


def assert_bf16_close(got, want, msg: str) -> None:
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, msg
    scale = float(np.abs(w).max())
    err = np.abs(g - w)
    assert float(err.max()) <= MAX_TOL * scale, (msg, float(err.max()),
                                                 scale)
    assert float(err.mean()) <= MEAN_TOL * scale, (msg, float(err.mean()),
                                                   scale)


def assert_caches_close(tc: dict, jc: dict) -> None:
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        assert str(tc[name].dtype).removeprefix("torch.") == str(
            jc[name].dtype), name
        if name == "len":
            assert int(tc[name]) == int(jc[name])
        else:
            assert_bf16_close(tc[name], jc[name], name)


def serve_pair(name: str, jbatch: dict, tbatch: dict, S: int, steps,
               seed: int = 0) -> None:
    """Prefill ``S`` positions into a cache of ``S + len(steps)`` in both
    packages, then one decode step for each ``(tokens, positions)`` of
    ``steps``: logits and cache leaves within the bf16 tolerances."""
    jcfg, tcfg = configs(name)
    jparams, tparams = weights(jcfg, tcfg, seed)
    jm, tm = j_build(jcfg), build_model(tcfg, "cpu")
    n = len(steps)
    jlog, jc = jax.jit(jm.prefill, static_argnums=2)(jparams, jbatch, S + n)
    tlog, tc = tm.prefill(tparams, tbatch, max_len=S + n)
    assert_bf16_close(tlog, jlog, f"{name} prefill logits")
    assert_caches_close(tc, jc)
    jdecode = jax.jit(jm.decode_step)
    for t, (tok, pos) in enumerate(steps):
        kw = {} if pos is None else {"positions": pos}
        jlog, jc = jdecode(jparams, jnp.asarray(tok), jc,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
        tlog, tc = tm.decode_step(tparams, torch.from_numpy(tok), tc,
                                  **{k: torch.from_numpy(v)
                                     for k, v in kw.items()})
        assert_bf16_close(tlog, jlog, f"{name} decode step {t} logits")
        assert_caches_close(tc, jc)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "hymba-1.5b"])
def test_prefill_and_decode_at_bf16(name):
    """Token prompts of 16 (two of hymba's SSM chunks of 8), 4 steps."""
    tcfg = get_smoke_config(name)
    tok = tokens(tcfg.vocab, (2, 20), seed=1)
    serve_pair(name, {"tokens": jnp.asarray(tok[:, :16])},
               {"tokens": torch.from_numpy(tok[:, :16])}, 16,
               [(tok[:, t:t + 1], None) for t in range(16, 20)])


def test_whisper_prefill_and_decode_at_bf16():
    """8-token prompts after 16 frames, then 4 steps; the decoder's and
    the cross attention's K/V caches held in bf16."""
    tcfg = get_smoke_config("whisper-large-v3")
    rng = np.random.default_rng(1)
    frames = rng.normal(0, 1, (2, tcfg.enc_seq, tcfg.d_model)).astype(
        np.float32)
    tok = tokens(tcfg.vocab, (2, 12), seed=3)
    batch = {"tokens": tok[:, :8], "frames": frames}
    serve_pair("whisper-large-v3",
               {k: jnp.asarray(v) for k, v in batch.items()},
               {k: torch.from_numpy(v) for k, v in batch.items()}, 8,
               [(tok[:, t:t + 1], None) for t in range(8, 12)], seed=2)


def test_vlm_mrope_prefill_and_decode_at_bf16():
    """qwen2-vl-72b: 9 patch embeddings (a 3 x 3 grid, in bf16) and 8
    tokens at Qwen2-VL's (t, h, w) positions, then 4 steps at (B, 1, 3)
    positions."""
    tcfg = get_smoke_config("qwen2-vl-72b")
    b = vlm_batch(tcfg, 2, 3, 12, seed=5)
    S = 9 + 8
    pre = {"patch_embeds": b["patch_embeds"], "tokens": b["tokens"][:, :8],
           "positions": b["positions"][:, :S]}
    jpre = {k: jnp.asarray(v) for k, v in pre.items()}
    jpre["patch_embeds"] = jpre["patch_embeds"].astype(jnp.bfloat16)
    tpre = {k: torch.from_numpy(v) for k, v in pre.items()}
    tpre["patch_embeds"] = tpre["patch_embeds"].to(torch.bfloat16)
    serve_pair("qwen2-vl-72b", jpre, tpre, S,
               [(b["tokens"][:, t:t + 1], b["positions"][:, 9 + t:10 + t])
                for t in range(8, 12)], seed=5)


def route_both(x: np.ndarray, router: np.ndarray, C: int):
    """Both packages' ``_route_group`` over groups of bf16 states."""
    jcfg, tcfg = configs("granite-moe-3b-a800m")
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tb = torch.from_numpy(x).to(torch.bfloat16)
    jslot, _, jkeep, _ = jax.vmap(lambda xt: JM._route_group(
        xt, jnp.asarray(router), jcfg, C))(xb)
    slot, _, keep, _ = TM._route_group(tb, torch.from_numpy(router), tcfg, C)
    return (np.asarray(jslot), np.asarray(jkeep)), (slot.numpy(),
                                                    keep.numpy())


@pytest.mark.parametrize("grid,C", [(False, 20), (False, 8), (True, 20),
                                    (True, 8)])
def test_granite_routing_at_bf16_ties(grid, C):
    """granite's router (4 experts, top-2) over 4 groups of 32 bf16
    states, at its own capacity (20 a group) and at 8, where full experts
    drop lanes.  ``grid``: states in {-1, 0, 1} and router entries in
    quarters, so the f32 logits are exact and experts tie for a token's
    top-2 often; ties go to the lower expert (``lax.top_k``'s order), so
    the same lanes are dropped.  Every drop is reported: (group, token,
    k) and whether the token's top-2 held a tie."""
    jcfg, tcfg = configs("granite-moe-3b-a800m")
    E, K, d = tcfg.moe.num_experts, tcfg.moe.top_k, tcfg.d_model
    assert C == 20 or C < int(32 * K * tcfg.moe.capacity_factor / E)
    rng = np.random.default_rng(21)
    if grid:
        x = rng.integers(-1, 2, (4, 32, d)).astype(np.float32)
        router = (rng.integers(-2, 3, (d, E)) / 4).astype(np.float32)
    else:
        x = rng.normal(0, 1, (4, 32, d)).astype(np.float32)
        router = np.asarray(JM.moe_init(jax.random.PRNGKey(0), jcfg)
                            ["router"])
    (jslot, jkeep), (slot, keep) = route_both(x, router, C)
    np.testing.assert_array_equal(slot, jslot)
    np.testing.assert_array_equal(keep, jkeep)
    logits = x @ router                      # exact on the grid
    srt = -np.sort(-logits, axis=-1)
    tie = (srt[..., K - 1] == srt[..., K]) | (srt[..., 0] == srt[..., 1])
    drops = [(int(g), int(i // K), int(i % K), bool(tie[g, i // K]))
             for g, i in zip(*np.nonzero(~keep))]
    print(f"grid={grid} C={C}: {int(tie.sum())} tokens with a top-{K} "
          f"tie, {len(drops)} lanes dropped, at a tie (group, token, k): "
          f"{[lane[:3] for lane in drops if lane[3]]}")
    if grid and C == 8:
        # the case this test is for: a full expert drops a tied lane
        assert any(t for *_, t in drops)


@pytest.mark.parametrize("grid", [False, True])
def test_granite_apply_moe_at_bf16(grid):
    jcfg, tcfg = configs("granite-moe-3b-a800m")
    jp = JM.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(22)
    if grid:
        x = rng.integers(-1, 2, (4, 32, tcfg.d_model)).astype(np.float32)
    else:
        x = rng.normal(0, 1, (4, 32, tcfg.d_model)).astype(np.float32)
    jout, jaux = JM.apply_moe(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    tout, taux = TM.apply_moe(tp, torch.from_numpy(x).to(torch.bfloat16),
                              tcfg)
    assert tout.dtype == torch.bfloat16
    assert_bf16_close(tout, jout, "apply_moe")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
