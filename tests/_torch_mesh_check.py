"""Subprocess helper for tests/test_torch_sharded_steps.py: the
model-parallel train, prefill and serve steps on one mesh shape, in one
of two roles that run at the same time and never talk to each other:

  * ``ref <data>,<model> <out>`` — ``repro``'s sharded steps under
    ``jax.jit`` with ``in_shardings``, on ``data * model`` forced host
    devices in a mesh with Auto axes (``jax.sharding.Mesh``;
    ``jax.make_mesh`` makes Explicit axes, which ``repro``'s shard
    points refuse under jax 0.9), writing ``<out>/ref.npz``;
  * ``rank <i> <P> <port> <data>,<model> <out>`` — rank ``i`` of ``P``
    gloo processes on localhost running the port's steps over a
    ``DeviceMesh`` of that shape (no JAX is imported), rank 0 writing
    ``<out>/port.npz`` (every DTensor gathered whole) and each rank
    ``<out>/rank<i>.json``: its local parameter and optimizer bytes
    against ``bytes_per_device``, and, on 2 ranks, ``make_debug_mesh``'s
    shape and the policy's bytes against ``policy_shardings``' plan.

Both roles draw the same weights (the port's ``Model.init`` from a seed,
as numpy, loaded by ``repro`` as they are and by the port through
``params_from_jax``) and the same numpy batches, and run, for each
case, under ``BASELINE_RULES``: the gradient at the initial weights,
three ``make_train_step`` steps (losses, MoE aux losses, final
parameters), a prefill that fills its cache (blocked where the family
has it: logits, next tokens, cache), and a prefill with room for 8
greedy ``make_serve_step`` steps (tokens, final cache).  The caches are
whole: the KV rows, a hybrid's SSM state, an xLSTM's recurrent states,
Whisper's cross K/V.  The ranks also train the blocked qwen3 two steps
in 2 microbatches, sharded and unsharded.

On the (1, 2) mesh the ranks also run ``OTHER_ARCHS`` (the registry's
archs no case runs: qwen3-14b, dbrx-132b) sharded and unsharded.  Both
roles also place an LM policy of 2^20 params or
more over a TokenRagged-v0 pool of 2 shards (``place_params``: ``repro``
on its 2 devices, the port across its 2 processes) and collect 6 greedy
recvs (the actions of every shard), and run one ``decode_step`` on the
placed weights (logits); the ranks run both with the policy whole too.
"""

import datetime
import json
import os
import sys

MODE = sys.argv[1]
if MODE == "ref":
    SHAPE = tuple(int(x) for x in sys.argv[2].split(","))
    OUT = sys.argv[3]
    from repro.launch.mesh import force_host_device_count

    force_host_device_count(SHAPE[0] * SHAPE[1])
elif MODE == "rank":
    RANK, WORLD, PORT = (int(x) for x in sys.argv[2:5])
    SHAPE = tuple(int(x) for x in sys.argv[5].split(","))
    OUT = sys.argv[6]
else:  # pragma: no cover
    raise SystemExit(f"unknown mode {MODE!r}")

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils.tree import tree_leaves_with_path  # noqa: E402

# (case, arch, variant); the 6-head qwen3 and the 6-expert granite run
# on a model axis of 4 only: the qwen3 splits its flat q dim evenly and
# its heads unevenly (the heads are then gathered and replicated), the
# granite's experts do not divide the axis (replicated: every rank runs
# every expert).  ``num_experts`` is a field of the config's ``moe``
CASES = [
    ("qwen3-dense", "qwen3-0.6b", {}),
    ("qwen3-blocked", "qwen3-0.6b", {"attn_impl": "blocked"}),
    ("llama", "llama3.2-3b", {"attn_impl": "blocked"}),
    ("starcoder2", "starcoder2-3b", {"attn_impl": "blocked",
                                     "attn_type": "sliding", "window": 32}),
    ("qwen2-vl", "qwen2-vl-72b", {"attn_impl": "blocked"}),
    ("qwen3-6heads", "qwen3-0.6b", {"attn_impl": "blocked", "n_heads": 6,
                                    "n_kv_heads": 2}),
    ("granite", "granite-moe-3b-a800m", {"attn_impl": "blocked"}),
    ("granite-6experts", "granite-moe-3b-a800m", {"attn_impl": "blocked",
                                                  "num_experts": 6}),
    ("hymba", "hymba-1.5b", {"attn_impl": "blocked"}),
    ("xlstm", "xlstm-125m", {}),
    ("whisper", "whisper-large-v3", {}),
]
ONLY_ON_4 = ("qwen3-6heads", "granite-6experts")
# the registry's other archs, whose families the cases cover: on the 2
# ranks, sharded against unsharded only
OTHER_ARCHS = ("qwen3-14b", "dbrx-132b")
FAMILIES = ("granite", "granite-6experts", "hymba", "xlstm", "whisper")
# the meshes that run the MoE, hybrid, xLSTM and Whisper cases
FAMILY_MESHES = ((1, 2), (2, 2), (1, 4))
B, S = 4, 48                 # train batch; the blocked prefill fills S
PROMPT, SERVE_STEPS = 40, 8  # the served prefill, cache S
GRID = 2                     # qwen2-vl: a 2 x 2 patch grid first
LR, WARMUP, TOTAL = 1e-3, 2, 10
TRAIN_STEPS = 3
# the policy: a TokenRagged-v0 pool of N lanes, M a recv, 2 shards;
# default_policy_config widened past 2^20 params; greedy recvs
POLICY_N, POLICY_M, POLICY_STEPS, POLICY_LEN = 8, 4, 6, 16
POLICY_WIDTH = {"d_model": 256, "d_ff": 1024, "head_dim": 64}


def configure(cfg, variant: dict):
    """``cfg`` (either package's) with ``variant``'s fields, f32 compute
    (``num_experts`` into its ``moe``)."""
    import dataclasses

    variant = dict(variant)
    experts = variant.pop("num_experts", None)
    if experts is not None:
        variant["moe"] = dataclasses.replace(cfg.moe, num_experts=experts)
    return cfg.replace(**variant)


def port_config(arch: str, variant: dict):
    return configure(get_smoke_config(arch).replace(
        compute_dtype=torch.float32), variant)


def numpy_weights(tcfg, seed: int = 0) -> dict:
    """The port's ``Model.init`` from ``seed`` as a numpy tree in
    ``repro``'s layout (layers stacked)."""
    params = build_model(tcfg, "cpu").init(torch.Generator().manual_seed(
        seed))

    return to_numpy(params)


def to_numpy(tree):
    """A tree of tensors (dicts, lists, tuples) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.numpy()


def mrope_positions(n: int, text: int) -> np.ndarray:
    """Qwen2-VL's ids (n, GRID^2 + text, 3): patches at (0, row, col),
    then text from GRID on with t = h = w."""
    r, c = np.divmod(np.arange(GRID * GRID), GRID)
    patches = np.stack([np.zeros_like(r), r, c], -1)
    t = GRID + np.arange(text)
    pos = np.concatenate([patches, np.stack([t, t, t], -1)])
    return np.broadcast_to(pos, (n,) + pos.shape).astype(np.int32).copy()


def batches(tcfg, seed: int) -> dict:
    """Numpy inputs of one case: ``train`` (3 batches), ``prefill`` (S
    positions), ``serve`` (the PROMPT-position prompt) and ``decode``
    (SERVE_STEPS positions, vlm only)."""
    rng = np.random.default_rng(seed)
    vlm = tcfg.family == "vlm"
    P = GRID * GRID if vlm else 0

    def toks(n):
        return rng.integers(0, tcfg.vocab, (B, n)).astype(np.int32)

    def frames():
        return rng.normal(0, 0.02, (B, tcfg.enc_seq, tcfg.d_model)
                          ).astype(np.float32)

    out = {"train": []}
    for _ in range(TRAIN_STEPS):
        t = toks(S - P + 1)
        b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if tcfg.family == "encdec":
            b["frames"] = frames()
        if vlm:
            b["patch_embeds"] = rng.normal(0, 0.02, (B, P, tcfg.d_model)
                                           ).astype(np.float32)
            b["positions"] = mrope_positions(B, S - P)
        out["train"].append(b)
    for kind, n in (("prefill", S), ("serve", PROMPT)):
        b = {"tokens": toks(n - P)}
        if tcfg.family == "encdec":
            b["frames"] = frames()
        if vlm:
            b["patch_embeds"] = rng.normal(0, 0.02, (B, P, tcfg.d_model)
                                           ).astype(np.float32)
            b["positions"] = mrope_positions(B, n - P)
        out[kind] = b
    if vlm:
        full = mrope_positions(B, PROMPT - P + SERVE_STEPS)
        out["decode"] = [full[:, PROMPT + j:PROMPT + j + 1]
                         for j in range(SERVE_STEPS)]
    return out


def cases():
    for seed, (case, arch, variant) in enumerate(CASES):
        if case in ONLY_ON_4 and SHAPE[1] != 4:
            continue
        if case in FAMILIES and SHAPE not in FAMILY_MESHES:
            continue
        tcfg = port_config(arch, variant)
        yield case, arch, variant, tcfg, numpy_weights(tcfg, seed), \
            batches(tcfg, seed)


# --------------------------------------------------------------------- #
# repro
# --------------------------------------------------------------------- #
def run_ref() -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.distributed.sharding as JS
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.launch import steps as JST
    from repro.models import build_model as j_build
    from repro.optim import adamw, linear_warmup_cosine

    mesh = Mesh(np.array(jax.devices()[:SHAPE[0] * SHAPE[1]]).reshape(
        SHAPE), ("data", "model"))
    rules = JS.BASELINE_RULES
    shard = JS.make_shard_fn(mesh, rules)
    opt = adamw(weight_decay=0.01)
    lr = linear_warmup_cosine(LR, WARMUP, TOTAL)
    out = {}

    def leaves(prefix, tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        for path, x in flat:
            name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            out[f"{prefix}.{name}"] = np.asarray(x, np.float64)

    for case, arch, variant, _, weights, data in cases():
        jcfg = configure(j_smoke(arch).replace(compute_dtype=jnp.float32,
                                               scan_layers=False), variant)
        jm = j_build(jcfg)
        params = jax.tree.map(jnp.asarray, weights)

        def arr(b):
            return {k: jnp.asarray(v) for k, v in b.items()}

        state = JST.TrainState(params=params, opt=opt.init(params),
                               step=jnp.zeros((), jnp.int32))
        ssh = JST.train_state_shardings(mesh, jax.eval_shape(lambda: state),
                                        rules)
        bsh = JST.batch_shardings(mesh, arr(data["train"][0]), rules)
        train_step = JST.make_train_step(jm, opt, lr, mesh, rules)
        grad = jax.grad(lambda p, b: jm.train_loss(p, b, shard=shard)[0])
        # one program a case for the train half (the gradient rides
        # along each step), one for both prefills: fewer compiles
        step = jax.jit(lambda st, b: (grad(st.params, b), train_step(st, b)),
                       in_shardings=(ssh, bsh))
        losses, aux = [], []
        for i, b in enumerate(data["train"]):
            # XLA may hand a leaf back in another layout than its plan
            state = jax.device_put(state, ssh)
            grads, (state, metrics) = step(state, arr(b))
            if i == 0:
                leaves(f"{case}/grad", grads)
            losses.append(float(metrics["loss"]))
            aux.append(float(metrics["aux"]))
        out[f"{case}/loss"] = np.asarray(losses)
        out[f"{case}/aux"] = np.asarray(aux)
        leaves(f"{case}/params", state.params)

        pb, sb = arr(data["prefill"]), arr(data["serve"])
        prefills = jax.jit(
            lambda p, a, b: (jm.prefill(p, a, max_len=S, shard=shard),
                             jm.prefill(p, b, max_len=S, shard=shard)),
            in_shardings=(ssh.params, JST.batch_shardings(mesh, pb, rules),
                          JST.batch_shardings(mesh, sb, rules)))
        (logits, cache), (slogits, scache) = prefills(params, pb, sb)
        out[f"{case}/prefill.logits"] = np.asarray(logits, np.float64)
        out[f"{case}/prefill.tokens"] = np.asarray(jnp.argmax(logits, -1))
        leaves(f"{case}/prefill.cache", without_len(cache))

        tok, cache = jnp.argmax(slogits, -1).astype(jnp.int32), scache
        csh = JST.cache_shardings(mesh, jax.eval_shape(lambda: cache), rules)
        cache = jax.device_put(cache, csh)     # onto the cache's plan
        serve = None
        toks = []
        for j in range(SERVE_STEPS):
            db = {"tokens": tok[:, None]}
            if "decode" in data:
                db["positions"] = jnp.asarray(data["decode"][j])
            if serve is None:
                serve = jax.jit(JST.make_serve_step(jm, mesh, rules),
                                in_shardings=(ssh.params, csh,
                                              JST.batch_shardings(
                                                  mesh, db, rules)))
            # XLA may hand a leaf back in another layout than its plan
            tok, cache = serve(params, jax.device_put(cache, csh), db)
            toks.append(np.asarray(tok))
        out[f"{case}/serve.tokens"] = np.stack(toks)
        leaves(f"{case}/serve.cache", without_len(cache))
    if SHAPE == (1, 2):
        out.update(ref_policy())
    np.savez(os.path.join(OUT, "ref.npz"), **out)


def ref_policy() -> dict:
    """``repro``'s collect and decode step with the policy placed on its
    2 devices."""
    import jax
    import jax.numpy as jnp

    import repro
    from repro.rl import policy_lm as jlm

    pool = repro.make("TokenRagged-v0", num_envs=POLICY_N,
                      batch_size=POLICY_M, engine="device-sharded",
                      num_shards=2)
    V = int(pool.spec.act_spec.maximum) + 1
    pol = jlm.LMPolicy(pool.spec, jlm.default_policy_config(
        V, POLICY_LEN).replace(**POLICY_WIDTH), max_len=POLICY_LEN)
    import repro_torch

    spec = repro_torch.make("TokenRagged-v0", num_envs=POLICY_N,
                            batch_size=POLICY_M, device="cpu").spec
    params = pol.place_params(jax.tree.map(jnp.asarray,
                                           policy_weights(spec, V)), pool)
    collect = jlm.build_lm_collect_fn(pool, pol, POLICY_STEPS, cached=True,
                                      greedy=True, donate=False)
    ps, ts = pool.reset(jax.random.PRNGKey(5))
    *_, acts = collect(ps, pol.init_lanes(POLICY_N), params, ts,
                       jax.random.PRNGKey(1))
    logits = jax.jit(pol.decode_step)(params, jnp.asarray(probe_tokens(V)),
                                      *blank_lanes(pol))[0]
    return {"policy/actions": np.asarray(acts),
            "policy/logits": np.asarray(logits, np.float64)}


def blank_lanes(pol):
    """Zero K/V caches of ``POLICY_M`` lanes and their positions: the
    logits probe's."""
    blank = pol.init_lanes(POLICY_M)
    return blank.k, blank.v, blank.length


def probe_tokens(V: int) -> np.ndarray:
    """The logits probe's tokens, one a lane."""
    return np.random.default_rng(7).integers(0, V, POLICY_M).astype(
        np.int32)


def policy_weights(spec, V: int) -> dict:
    """The port's ``LMPolicy.init`` of the widened config over the port's
    env ``spec``, as numpy."""
    from repro_torch.rl import policy_lm as tlm

    pol = tlm.LMPolicy(spec, tlm.default_policy_config(
        V, POLICY_LEN).replace(**POLICY_WIDTH), max_len=POLICY_LEN,
        device="cpu")

    return to_numpy(pol.init(torch.Generator().manual_seed(11)))


def without_len(cache) -> dict:
    """Every leaf of a cache but its ``len``."""
    return {k: v for k, v in cache.items() if k != "len"}


# --------------------------------------------------------------------- #
# the port
# --------------------------------------------------------------------- #
def run_rank() -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    import repro_torch.distributed.sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.rl.policy_lm import params_from_jax

    # a rank that fails leaves the others waiting in a collective: give
    # up after 3 minutes, not gloo's default 30
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{PORT}",
                            world_size=WORLD, rank=RANK,
                            timeout=datetime.timedelta(minutes=3))
    mesh = init_device_mesh("cpu", SHAPE, mesh_dim_names=("data", "model"))
    rules = TS.BASELINE_RULES
    shard = TS.make_shard_fn(mesh, rules)
    opt = adamw(weight_decay=0.01)
    lr = linear_warmup_cosine(LR, WARMUP, TOTAL)
    out, report = {}, {"bytes": {}}

    def whole(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def leaves(prefix, tree):
        for name, x in tree_leaves_with_path(tree):
            out[f"{prefix}.{name}"] = whole(x).detach().double().numpy()

    def local_bytes(tree):
        return sum(x.to_local().numel() * x.element_size()
                   for _, x in tree_leaves_with_path(tree))

    for case, arch, variant, tcfg, weights, data in cases():
        model = build_model(tcfg, "cpu")
        params = params_from_jax(weights, tcfg, "cpu")

        def ten(b):
            return {k: torch.from_numpy(v) for k, v in b.items()}

        state = TST.TrainState(params=params, opt=opt.init(params),
                               step=torch.zeros((), dtype=torch.int32))
        plan = TST.train_state_shardings(mesh, state, rules)
        b0 = ten(data["train"][0])
        with implicit_replication():
            _, _, grads = TST.loss_and_grads(
                model, TS.place(params, plan.params, mesh),
                TS.place(b0, TST.batch_shardings(mesh, b0, rules), mesh),
                1, shard)
        leaves(f"{case}/grad", grads)
        step = TST.make_train_step(model, opt, lr, mesh, rules)
        losses, aux = [], []
        for b in data["train"]:
            state, metrics = step(state, ten(b))
            losses.append(float(metrics["loss"]))
            aux.append(float(metrics["aux"]))
        out[f"{case}/loss"] = np.asarray(losses)
        out[f"{case}/aux"] = np.asarray(aux)
        leaves(f"{case}/params", state.params)
        if case == "qwen3-blocked":
            # two steps in 2 microbatches, sharded against unsharded
            # (``repro``'s microbatches: tests/test_torch_train_lm.py)
            for name, m in (("plain", None), ("sharded", mesh)):
                st = TST.TrainState(params=params, opt=opt.init(params),
                                    step=torch.zeros((), dtype=torch.int32))
                mb_step = TST.make_train_step(model, opt, lr, m, rules,
                                              microbatches=2)
                mb_losses = []
                for b in data["train"][:2]:
                    st, metrics = mb_step(st, ten(b))
                    mb_losses.append(float(metrics["loss"]))
                out[f"{case}/mb_{name}_loss"] = np.asarray(mb_losses)
                leaves(f"{case}/mb_{name}_params", st.params)
        report["bytes"][case] = {
            "params": [local_bytes(state.params), TS.bytes_per_device(
                state.params, plan.params, mesh)],
            "opt": [local_bytes(state.opt), TS.bytes_per_device(
                state.opt, plan.opt, mesh)]}

        # the cache-filling prefill through the model (its logits), the
        # served one below through make_prefill_step
        pb = ten(data["prefill"])
        with implicit_replication():
            logits, cache = model.prefill(
                TS.place(params, plan.params, mesh),
                TS.place(pb, TST.batch_shardings(mesh, pb, rules), mesh),
                max_len=S, shard=shard)
        logits = whole(logits)
        out[f"{case}/prefill.logits"] = logits.double().numpy()
        out[f"{case}/prefill.tokens"] = logits.argmax(-1).numpy()
        leaves(f"{case}/prefill.cache", without_len(cache))

        tok, cache = TST.make_prefill_step(model, S, mesh, rules)(
            params, ten(data["serve"]))
        serve = TST.make_serve_step(model, mesh, rules)
        toks = []
        for j in range(SERVE_STEPS):
            db = {"tokens": tok[:, None]}
            if "decode" in data:
                db["positions"] = torch.from_numpy(data["decode"][j])
            tok, cache = serve(params, cache, db)
            toks.append(tok.numpy())
        out[f"{case}/serve.tokens"] = np.stack(toks)
        leaves(f"{case}/serve.cache", without_len(cache))

    if WORLD == 2:
        debug = make_debug_mesh(device="cpu")
        report["debug_mesh"] = [list(debug.mesh_dim_names),
                                list(debug.shape)]
        policy, report["policy"] = rank_policy()
        out.update(policy)
        out.update(rank_other_archs(mesh, rules))
    if RANK == 0:
        np.savez(os.path.join(OUT, "port.npz"), **out)
    with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def rank_other_archs(mesh, rules) -> dict:
    """The registry's archs that no case above runs (``OTHER_ARCHS``):
    one train step, a prefill and 2 serve steps, sharded and unsharded
    on the same weights (the port alone: their families are held to
    ``repro`` by the cases above)."""
    from repro_torch.launch import steps as TST
    from repro_torch.optim import adamw, constant

    out = {}
    for arch in OTHER_ARCHS:
        tcfg = port_config(arch, {"attn_impl": "blocked"})
        model = build_model(tcfg, "cpu")
        params = model.init(torch.Generator().manual_seed(3))
        data = batches(tcfg, 3)
        opt = adamw(weight_decay=0.01)
        for name, m in (("plain", None), ("sharded", mesh)):
            state = TST.TrainState(params=params, opt=opt.init(params),
                                   step=torch.zeros((), dtype=torch.int32))
            state, _ = TST.make_train_step(model, opt, constant(LR), m,
                                           rules)(state, {
                k: torch.from_numpy(v) for k, v in data["train"][0].items()})
            tok, cache = TST.make_prefill_step(model, S, m, rules)(
                params, {"tokens": torch.from_numpy(data["serve"]["tokens"])})
            toks = [tok]
            for _ in range(2):
                tok, cache = TST.make_serve_step(model, m, rules)(
                    params, cache, {"tokens": tok[:, None]})
                toks.append(tok)
            out[f"{arch}/{name}_tokens"] = torch.stack(toks).numpy()
            for path, x in tree_leaves_with_path(state.params):
                x = x.full_tensor() if hasattr(x, "full_tensor") else x
                out[f"{arch}/{name}_params.{path}"] = x.double().numpy()
    return out


def rank_policy() -> tuple[dict, dict]:
    """The port's collect and decode step with the policy placed across
    the 2 processes, and with it whole: (arrays, this rank's bytes
    against the plan)."""
    import repro_torch
    from repro_torch.distributed.sharding import policy_shardings
    from repro_torch.rl import policy_lm as tlm
    from repro_torch.utils.tree import is_value, tree_leaves

    pool = repro_torch.make("TokenRagged-v0", num_envs=POLICY_N,
                            batch_size=POLICY_M, engine="device-sharded",
                            num_shards=2, device="cpu")
    V = int(pool.spec.act_spec.maximum) + 1
    cfg = tlm.default_policy_config(V, POLICY_LEN).replace(**POLICY_WIDTH)
    pol = tlm.LMPolicy(pool.spec, cfg, max_len=POLICY_LEN, device="cpu")
    params = tlm.params_from_jax(policy_weights(pool.spec, V), cfg, "cpu")
    placed = pol.place_params(params, pool)
    plan = policy_shardings(pool.mesh, params)
    planned = sum(x.numel() * x.element_size() // (1 if d is None else 2)
                  for x, d in zip(tree_leaves(params),
                                  tree_leaves(plan, is_leaf=lambda v: True)))
    held = sum(x.numel() * x.element_size() for x in tree_leaves(placed))
    report = {"params": sum(x.numel() for x in tree_leaves(params)),
              "bytes": [held, planned],
              "sharded_leaves": len(tree_leaves(plan, is_leaf=is_value))}
    out = {}
    for name, p in (("", placed), ("whole_", params)):
        collect = tlm.build_lm_collect_fn(pool, pol, POLICY_STEPS,
                                          cached=True, greedy=True)
        ps, ts = pool.reset(repro_torch.random.PRNGKey(5))
        *_, acts = collect(ps, pol.init_lanes(POLICY_N), p, ts,
                           repro_torch.random.PRNGKey(1))
        out[f"policy/{name}actions"] = pool.mesh.gather(
            acts, "test", dim=1).numpy()
        logits = pol.decode_step(p, torch.from_numpy(probe_tokens(V)),
                                 *blank_lanes(pol))[0]
        out[f"policy/{name}logits"] = logits.double().numpy()
    return out, report


if __name__ == "__main__":
    run_ref() if MODE == "ref" else run_rank()
