"""``repro_torch.make`` against ``repro.make`` run live in the same
process (never the .npz goldens, which jax 0.9 no longer reproduces):
the scripted rollout of tests/test_conformance.py::golden_device_stream
through both packages, 30 steps with 5-step episodes so auto-reset runs.

ids, done, terminated, truncated, step_cost and episode_length are
exact; Pong obs and reward are bitwise; Ant obs and reward are held to
atol=1e-4 (XLA's fused multiply-adds and ``cos`` differ from torch's in
the last bit, and the physics carries that over 30 steps).

Also: a ``PoolState`` carried across from the JAX package continues the
same stream; importing and running the port pulls in neither ``jax`` nor
``repro``; ``make`` refuses what the port does not have yet (the sharded
engine) and builds the host engines.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.registry as jax_registry  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    pool_state_from_numpy,
    pool_state_to_numpy,
)
from repro_torch.core.registry import (  # noqa: E402
    default_transforms,
    register,
)
from repro_torch.core.scheduler import (  # noqa: E402
    SchedState,
    get_scheduler,
)
from repro_torch.envs.classic import CartPole  # noqa: E402

from _torch_pair import compare, jax_leaves, rollout  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 30


def policy(ids: np.ndarray, t: int, continuous: bool) -> np.ndarray:
    """Deterministic per-(env, step) action, routed by env_id."""
    if continuous:
        table = np.random.default_rng(1000 + t).uniform(
            -1.2, 1.2, (64, 8)).astype(np.float32)
        return table[ids]
    return ((ids.astype(np.int64) * 7 + t) % 6).astype(np.int32)


def pools(task, n, m, schedule, obs):
    jp = jax_registry.make(task, num_envs=n, batch_size=m, schedule=schedule,
                           obs=obs, max_episode_steps=5)
    tp = repro_torch.make(task, num_envs=n, batch_size=m, schedule=schedule,
                          device="cpu", max_episode_steps=5, obs=obs)
    return jp, tp


@pytest.mark.parametrize("task,n,m,schedule", [
    ("Ant-v3", 8, None, "fifo"),
    ("Ant-v3", 8, 4, "fifo"),
    ("PongClassic-v5", 4, None, "fifo"),
    ("PongClassic-v5", 4, 2, "fifo"),
    ("PongClassic-v5", 4, 2, "sjf"),
])
def test_streams_match_repro(task, n, m, schedule):
    continuous = task.startswith("Ant")
    atol = 1e-4 if continuous else 0.0
    jp, tp = pools(task, n, m, schedule, obs=True)
    assert tp.spec.obs_spec.shape == jp.spec.obs_spec.shape
    jps, jts = jp.reset(jax.random.PRNGKey(0))
    tps, tts = tp.reset(repro_torch.random.PRNGKey(0))
    jstep = jax.jit(jp.step)
    for t in range(STEPS):
        compare(f"{task} step {t}", jts, tts, atol)
        if m is not None:
            assert len(set(tts.env_id.tolist())) == m
        a = policy(np.asarray(jts.env_id), t, continuous)
        jps, jts = jstep(jps, jnp.asarray(a), jts.env_id)
        tps, tts = tp.step(tps, torch.from_numpy(a), tts.env_id)
    compare(f"{task} step {STEPS}", jts, tts, atol)


def test_pool_state_carried_across_continues_the_stream():
    """The JAX package's PoolState, mid-rollout, loaded into the port:
    both continue with the same blocks (Pong, async, so the state holds
    READY and WAITING lanes and a frame stack)."""
    jp, tp = pools("PongClassic-v5", 4, 2, "fifo", obs=False)
    jps, jts = jp.reset(jax.random.PRNGKey(3))
    jstep = jax.jit(jp.step)
    for t in range(7):
        jps, jts = jstep(jps, jnp.asarray(policy(np.asarray(jts.env_id), t,
                                                 False)), jts.env_id)
    arrays = jax_leaves(jps)
    tps = pool_state_from_numpy(tp, arrays)
    back = pool_state_to_numpy(tp, tps)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    tts_ids = torch.from_numpy(np.asarray(jts.env_id))
    for t in range(7, 17):
        a = policy(np.asarray(jts.env_id), t, False)
        jps, jts = jstep(jps, jnp.asarray(a), jts.env_id)
        tps, tts = tp.step(tps, torch.from_numpy(a), tts_ids)
        compare(f"carried step {t}", jts, tts, 0.0)
        tts_ids = tts.env_id
    with pytest.raises(KeyError):
        pool_state_from_numpy(tp, {k: v for k, v in arrays.items()
                                   if k != "tick"})


def test_running_the_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, torch, repro_torch\n"
        "assert 'repro_torch.kernels.build' not in sys.modules\n"
        "for task in ('Ant-v3', 'PongClassic-v5'):\n"
        "    pool = repro_torch.make(task, num_envs=4, batch_size=2,\n"
        "                            device='cpu')\n"
        "    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))\n"
        "    ps, ts = pool.step(ps, torch.zeros((2,) + pool.spec.act_spec\n"
        "                       .shape, dtype=pool.spec.act_spec.dtype),\n"
        "                       ts.env_id)\n"
        "import tempfile\n"
        "from repro_torch.checkpoint.store import CheckpointStore\n"
        "from repro_torch.core.dm_api import DmEnv\n"
        "for task, engine in (('AntNorm-v3', 'device'),\n"
        "                     ('AntSkew-v3', 'device-masked'),\n"
        "                     ('Pendulum-v1', 'device')):\n"
        "    pool = repro_torch.make(task, num_envs=4, batch_size=2,\n"
        "                            engine=engine, device='cpu')\n"
        "    dm = DmEnv(pool)\n"
        "    ts = dm.reset()\n"
        "    dm.step(torch.zeros((2,) + pool.spec.act_spec.shape),\n"
        "            ts.observation.env_id)\n"
        "    pool.stats(dm._bound.state)\n"
        "    pool.save_transform_state(CheckpointStore(tempfile.mkdtemp()),\n"
        "                              1, dm._bound.state)\n"
        "from repro_torch.rl.policy_lm import LMPolicy, build_lm_collect_fn\n"
        "from repro_torch.serving import DecodePool\n"
        "pool = repro_torch.make('TokenRagged-v0', num_envs=4, batch_size=2,\n"
        "                        device='cpu')\n"
        "pol = LMPolicy(pool.spec, device='cpu')\n"
        "params = pol.init(torch.Generator().manual_seed(0))\n"
        "ps, ts = pool.reset(repro_torch.random.PRNGKey(0))\n"
        "build_lm_collect_fn(pool, pol, 2)(ps, pol.init_lanes(4), params, ts,\n"
        "                                  repro_torch.random.PRNGKey(1))\n"
        "DecodePool(pol, 2, 3).serve(params, [[1, 2], [3]])\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models import ShapeSpec, build_model\n"
        "from repro_torch.launch.steps import (make_prefill_step,\n"
        "    make_serve_step, synth_batch)\n"
        "cfg = get_smoke_config('starcoder2-3b').replace(\n"
        "    attn_type='sliding', window=4, attn_impl='blocked')\n"
        "model = build_model(cfg, 'cpu')\n"
        "params = model.init(torch.Generator().manual_seed(0))\n"
        "batch = synth_batch(model, ShapeSpec('p', 'prefill', 8, 2),\n"
        "                    torch.Generator().manual_seed(1))\n"
        "nxt, cache = make_prefill_step(model, 8)(params, batch)\n"
        "make_serve_step(model)(params, cache, {'tokens': nxt[:, None]})\n"
        "from repro_torch.core.xla_loop import build_random_collect_fn\n"
        "from repro_torch.rl import PPOConfig, train_device\n"
        "for task in ('Ant-v3', 'PongClassic-v5'):\n"
        "    pool = repro_torch.make(task, num_envs=2, device='cpu')\n"
        "    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))\n"
        "    build_random_collect_fn(pool, 2)(ps, None, ts,\n"
        "                                     repro_torch.random.PRNGKey(1))\n"
        "    train_device(pool, PPOConfig(total_steps=4, num_steps=2,\n"
        "                                 minibatches=1), hidden=(8,))\n"
        "import numpy as np\n"
        "from repro_torch.core import baselines, buffers, host_pool\n"
        "from repro_torch.envs import host_numpy\n"
        "from repro_torch.rl import train_host\n"
        "for engine in ('thread', 'forloop', 'subprocess'):\n"
        "    pool = repro_torch.make('Ant-v3', num_envs=2, engine=engine,\n"
        "                            num_threads=1, device='cpu')\n"
        "    train_host(pool, cfg=PPOConfig(total_steps=4, num_steps=2,\n"
        "                                   minibatches=1), hidden=(8,),\n"
        "               device='cpu')\n"
        "    pool.close()\n"
        "from repro_torch.rl import (train, train_host_pipelined,\n"
        "                            train_pipelined, vtrace)\n"
        "cfg = PPOConfig(total_steps=8, num_steps=2, minibatches=1)\n"
        "for task in ('Ant-v3', 'PongClassic-v5'):\n"
        "    pool = repro_torch.make(task, num_envs=2, device='cpu')\n"
        "    train_pipelined(pool, cfg, hidden=(8,))\n"
        "    train(pool, cfg, hidden=(8,))\n"
        "pool = repro_torch.make('Ant-v3', num_envs=2, engine='thread',\n"
        "                        num_threads=1, device='cpu')\n"
        "train_host_pipelined(pool, cfg=cfg, hidden=(8,), device='cpu')\n"
        "pool.close()\n"
        "from repro_torch.core import sharded_pool\n"
        "from repro_torch.distributed.sharding import policy_shardings\n"
        "from repro_torch.launch.mesh import multihost_info\n"
        "assert multihost_info()['process_count'] == 1\n"
        "for task, sched in (('AntNorm-v3', 'hierarchical'),\n"
        "                    ('PongClassic-v5', 'fifo')):\n"
        "    pool = sharded_pool.ShardedDeviceEnvPool(\n"
        "        repro_torch.core.registry._registry()[task][0](), 4, 2,\n"
        "        mesh=2, schedule=sched, device='cpu',\n"
        "        transforms=repro_torch.core.registry.default_transforms(task))\n"
        "    train_device(pool, PPOConfig(total_steps=4, num_steps=2,\n"
        "                                 minibatches=1), hidden=(8,))\n"
        "    policy_shardings(pool.mesh, {'w': torch.zeros(2)})\n"
        "env = repro_torch.make_py('Ant-v3')\n"
        "env.reset()\n"
        "env.step(np.zeros(8, np.float32))\n"
        "from repro_torch.data import BatchSpec, SyntheticSource\n"
        "from repro_torch.launch import train as train_cli\n"
        "from repro_torch.launch.steps import (init_train_state,\n"
        "    make_train_step, train_state_shapes)\n"
        "from repro_torch.models.common import model_flops_per_token\n"
        "from repro_torch.optim import adamw, constant\n"
        "cfg = get_smoke_config('qwen3-0.6b').replace(attn_impl='blocked')\n"
        "model = build_model(cfg, 'cpu')\n"
        "state = init_train_state(model, adamw(),\n"
        "                         torch.Generator().manual_seed(0))\n"
        "train_state_shapes(model, adamw())\n"
        "batch = SyntheticSource(cfg.vocab).batch(BatchSpec(2, 8, cfg.vocab), 0)\n"
        "make_train_step(model, adamw(), constant(1e-3), microbatches=2)(\n"
        "    state, {k: torch.from_numpy(v) for k, v in batch.items()})\n"
        "model_flops_per_token(cfg)\n"
        "import contextlib, io\n"
        "ck = tempfile.mkdtemp()\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    for steps in ('2', '3'):\n"
        "        train_cli.main(['--arch', 'qwen3-0.6b', '--smoke', '--steps',\n"
        "                        steps, '--batch', '2', '--seq', '8',\n"
        "                        '--device', 'cpu', '--ckpt-dir', ck])\n"
        "from repro_torch.configs import (dbrx_132b, granite_moe_3b,\n"
        "                                 hymba_1_5b)\n"
        "from repro_torch.models import moe, ssm\n"
        "for arch in ('granite-moe-3b-a800m', 'hymba-1.5b', 'dbrx-132b'):\n"
        "    cfg = get_smoke_config(arch).replace(attn_impl='blocked')\n"
        "    model = build_model(cfg, 'cpu')\n"
        "    params = model.init(torch.Generator().manual_seed(0))\n"
        "    batch = synth_batch(model, ShapeSpec('p', 'prefill', 8, 2),\n"
        "                        torch.Generator().manual_seed(1))\n"
        "    nxt, cache = make_prefill_step(model, 8)(params, batch)\n"
        "    make_serve_step(model)(params, cache, {'tokens': nxt[:, None]})\n"
        "    model.train_loss(params, dict(batch, labels=batch['tokens']))\n"
        "from repro_torch.configs import (qwen2_vl_72b, whisper_large_v3,\n"
        "                                 xlstm_125m)\n"
        "from repro_torch.models import whisper, xlstm\n"
        "for arch in ('xlstm-125m', 'whisper-large-v3', 'qwen2-vl-72b'):\n"
        "    model = build_model(get_smoke_config(arch).replace(\n"
        "        attn_impl='blocked'), 'cpu')\n"
        "    params = model.init(torch.Generator().manual_seed(0))\n"
        "    batch = synth_batch(model, ShapeSpec('p', 'prefill', 8, 2),\n"
        "                        torch.Generator().manual_seed(1))\n"
        "    nxt, cache = make_prefill_step(model, 8)(params, batch)\n"
        "    step = {'tokens': nxt[:, None]}\n"
        "    if arch == 'qwen2-vl-72b':\n"
        "        step['positions'] = torch.full((2, 1, 3), 8)\n"
        "    make_serve_step(model)(params, cache, step)\n"
        "    train = synth_batch(model, ShapeSpec('t', 'train', 8, 2),\n"
        "                        torch.Generator().manual_seed(2))\n"
        "    model.train_loss(params, train)\n"
        "from repro_torch.core.device_pool import DeviceEnvPool, make_pool\n"
        "from repro_torch.envs.classic import CartPole\n"
        "one = make_pool(CartPole(), 2, device='cpu')\n"
        "assert DeviceEnvPool is type(one)\n"
        "from repro_torch.configs import (llama3_2_3b, qwen3_14b,\n"
        "                                 starcoder2_3b)\n"
        "from repro_torch.distributed.analytic import cell_cost\n"
        "from repro_torch.models import SHAPES\n"
        "for mod in (llama3_2_3b, qwen3_14b, starcoder2_3b):\n"
        "    cell_cost(mod.get_config(), SHAPES['train_4k'], 256)\n"
        "from repro_torch.optim.compression import (compress_tree,\n"
        "    decompress_tree, init_error)\n"
        "g = {'w': torch.randn(300)}\n"
        "decompress_tree(compress_tree(g, init_error(g))[0], g)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.kernels.build' not in sys.modules\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_port_sources_import_neither_jax_nor_repro():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                         r"(\.|\s))", re.MULTILINE)
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "examples", f"{name}_torch.py")
        for name in ("train_lm", "quickstart", "async_vs_sync", "ppo_atari",
                     "serve_lm", "sharded_scaleout")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 10
    for part in (("models", "api.py"), ("models", "blocked_attention.py"),
                 ("launch", "steps.py"),
                 ("kernels", "flash_attention", "ops.py"),
                 ("core", "xla_loop.py"), ("rl", "ppo.py"),
                 ("rl", "nets.py"), ("optim", "adamw.py"),
                 ("obs", "telemetry.py"), ("core", "protocol.py"),
                 ("core", "dm_api.py"), ("checkpoint", "store.py"),
                 ("envs", "classic.py"), ("core", "host_pool.py"),
                 ("core", "baselines.py"), ("core", "buffers.py"),
                 ("envs", "host_numpy.py"), ("rl", "vtrace.py"),
                 ("core", "__init__.py"), ("data", "__init__.py"),
                 ("data", "pipeline.py"), ("launch", "train.py"),
                 ("models", "common.py"), ("core", "device_pool.py"),
                 ("optim", "compression.py"),
                 ("distributed", "analytic.py"),
                 ("configs", "qwen3_14b.py"), ("configs", "llama3_2_3b.py"),
                 ("configs", "starcoder2_3b.py")):
        assert os.path.join(ROOT, "src", "repro_torch", *part) in files
    offenders = []
    for path in files:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders


def test_make_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.make("Ant-v3", num_envs=4)
    assert repro_torch.make("Ant-v3", num_envs=4, device="cpu").device \
        == torch.device("cpu")


@pytest.mark.parametrize("kwargs,error", [
    ({"engine": "forloop"}, None),
    ({"engine": "device-sharded"}, None),
    ({"engine": "thread"}, None),
    ({"engine": "gpu-cluster"}, ValueError),
    ({"engine": "subprocess"}, None),
    ({"batch_size": 2, "schedule": "hierarchical"}, ValueError),
    ({"batch_size": 2, "schedule": "random"}, ValueError),
])
def test_make_refuses_what_is_not_ported(kwargs, error):
    """Unknown engines and schedules raise, and ``hierarchical`` on the
    one-device engine; the host engines and the sharded engine (one
    shard a process by default; ``error`` None) are ported: they build
    and serve a block of every env, tensors on the pool's device."""
    if error is not None:
        with pytest.raises(error):
            repro_torch.make("Ant-v3", num_envs=4, device="cpu", **kwargs)
        return
    pool = repro_torch.make("Ant-v3", num_envs=4, device="cpu",
                            num_threads=1, **kwargs)
    if kwargs["engine"] == "device-sharded":
        assert pool.num_shards == 1
        out = vars(pool.reset(repro_torch.random.PRNGKey(0))[1])
        pool.close = lambda: None
    try:
        out = out if kwargs["engine"] == "device-sharded" else pool.reset()
        assert tuple(out["obs"].shape) == (4, 29)
        assert sorted(out["env_id"].tolist()) == [0, 1, 2, 3]
        assert out["obs"].device == torch.device("cpu")
    finally:
        pool.close()


def test_registered_tasks_and_stats():
    """Every device-family task of ``repro.make`` (its pure-numpy envs
    are ``make_py``'s: tests/test_torch_host_engines.py);
    ``stats()`` by default, and a RuntimeError under ``obs=False``, as
    in ``repro``."""
    assert repro_torch.list_envs() == sorted([
        "Ant-v3", "MujocoLike-Ant-v3", "Pong-v5", "AtariLike-Pong-v5",
        "PongStack-v5", "PongClassic-v5", "TokenCopy-v0", "TokenSkew-v0",
        "TokenRagged-v0", "AntNorm-v3", "AntSkew-v3", "CartPole-v1",
        "MountainCar-v0", "Pendulum-v1"])
    assert repro_torch.list_envs() == jax_registry.list_envs()
    with pytest.raises(KeyError):
        repro_torch.make("Breakout-v5", num_envs=4, device="cpu")
    pool = repro_torch.make("PongStack-v5", num_envs=4, device="cpu")
    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
    assert tuple(ts.obs.shape) == (4, 4, 84, 84)
    stats = pool.stats(ps)
    assert (stats["recvs"], stats["served"], stats["stepped"]) == (1, 4, 0)
    pool = repro_torch.make("PongStack-v5", num_envs=4, device="cpu",
                            obs=False)
    with pytest.raises(RuntimeError, match="obs=False"):
        pool.stats(pool.reset(repro_torch.random.PRNGKey(0))[0])


@pytest.mark.parametrize("kwargs,item", [
    ({"num_threads": 4}, None),
    ({"num_shards": 2}, "device-sharded"),
    ({"mesh": 2}, "device-sharded"),
])
def test_make_names_the_item_of_each_unported_option(kwargs, item):
    """Each option goes to the engine that has it, as in ``repro.make``:
    ``num_threads`` (``item`` None) to the host engines, ``num_shards``
    and ``mesh`` to the sharded engine; the device engine ignores all
    three, and ``hierarchical`` needs the sharded one, whose shard count
    ``stats()`` and the blocks' ids bear out."""
    assert repro_torch.make("Ant-v3", num_envs=4, device="cpu",
                            **kwargs).num_envs == 4
    if item is None:
        pool = repro_torch.make("Ant-v3", num_envs=4, device="cpu",
                                engine="thread", **kwargs)
        try:
            assert pool.num_threads == 4
        finally:
            pool.close()
        return
    with pytest.raises(ValueError, match=item):
        repro_torch.make("Ant-v3", num_envs=4, device="cpu",
                         schedule="hierarchical", **kwargs)
    pool = repro_torch.make("Ant-v3", num_envs=4, batch_size=2,
                            device="cpu", engine=item,
                            schedule="hierarchical", **kwargs)
    assert (pool.num_shards, pool.mesh.num_shards) == (2, 2)
    ps, ts = pool.reset(repro_torch.random.PRNGKey(0))
    for _ in range(3):
        # one result from each shard's two lanes, shard-major
        ids = ts.env_id.tolist()
        assert ids[0] in (0, 1) and ids[1] in (2, 3)
        ps, ts = pool.step(ps, torch.zeros((2, 8)), ts.env_id)
    stats = pool.stats(ps)
    assert (stats["recvs"], stats["served"]) == (4, 8)


def test_make_takes_the_options_of_repro_make():
    """``repro.make``'s keywords reach ``make``, not the env factory;
    fifo and sjf use neither ``sched_patience`` nor ``cost_ema_alpha``;
    ``batched=True`` wants a native view, which the token envs have not
    in either package.  The port's Pong renders its block through the
    kernel in ``observe`` itself, so its view is the generic adapter and
    ``batched=True`` refuses it too (``repro`` has a separate native
    view for its render: ROADMAP C.3)."""
    for batched, view in ((None, "MujocoLikeBatch"), (True, "MujocoLikeBatch"),
                          (False, "VmapBatchEnv")):
        pool = repro_torch.make("Ant-v3", 4, device="cpu", batched=batched,
                                seed=3, sched_patience=0.5,
                                cost_ema_alpha=0.25, num_threads=None,
                                num_shards=None, mesh=None)
        assert type(pool.benv).__name__ == view
    for task in ("TokenCopy-v0", "PongClassic-v5"):
        with pytest.raises(ValueError, match="natively batched"):
            repro_torch.make(task, 4, device="cpu", batched=True)
    with pytest.raises(ValueError, match="natively batched"):
        jax_registry.make("TokenCopy-v0", 4, batched=True, obs=False)


@pytest.mark.parametrize("task,n,m", [
    ("Ant-v3", 8, None),
    ("Ant-v3", 8, 4),
    ("PongClassic-v5", 4, 2),
])
def test_unbatched_streams_match_the_default_and_repro(task, n, m):
    """``batched=False`` (the generic adapter) gives the port's default
    stream and ``repro``'s ``batched=False`` stream: ids, done and the
    other discrete fields exact, Pong obs and reward bitwise, Ant's
    within 1e-4."""
    continuous = task.startswith("Ant")
    atol = 1e-4 if continuous else 0.0
    jp = jax_registry.make(task, num_envs=n, batch_size=m, obs=False,
                           batched=False, max_episode_steps=5)
    tp = repro_torch.make(task, num_envs=n, batch_size=m, device="cpu",
                          batched=False, max_episode_steps=5)
    dp = repro_torch.make(task, num_envs=n, batch_size=m, device="cpu",
                          max_episode_steps=5)
    assert type(tp.benv).__name__ == "VmapBatchEnv"
    jps, jts = jp.reset(jax.random.PRNGKey(2))
    tps, tts = tp.reset(repro_torch.random.PRNGKey(2))
    dps, dts = dp.reset(repro_torch.random.PRNGKey(2))
    jstep = jax.jit(jp.step)
    for t in range(STEPS):
        compare(f"{task} step {t} vs repro", jts, tts, atol)
        compare(f"{task} step {t} vs default", dts, tts, atol)
        a = policy(np.asarray(jts.env_id), t, continuous)
        jps, jts = jstep(jps, jnp.asarray(a), jts.env_id)
        tps, tts = tp.step(tps, torch.from_numpy(a), tts.env_id)
        dps, dts = dp.step(dps, torch.from_numpy(a), dts.env_id)


@pytest.mark.parametrize("schedule", ["fifo", "sjf"])
def test_select_keeps_lax_top_k_tie_order(schedule):
    """Ties are the common case (fifo's READY band is -1e9 + send_tick
    in f32, where ulp(1e9) = 64): selection must put the lower lane
    index first among equal priorities, as lax.top_k(-priority) does."""
    rng = np.random.default_rng(6)
    n = 64
    ss = SchedState(
        phase=torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)),
        cost=torch.from_numpy(rng.integers(4, 7, n).astype(np.int32)),
        send_tick=torch.from_numpy(rng.integers(0, 40, n).astype(np.int32)),
        tick=torch.tensor(40, dtype=torch.int32),
    )
    sched = get_scheduler(schedule)
    prio = sched.priority(ss).numpy()
    assert len(np.unique(prio)) < n // 2          # plenty of ties
    for m in (1, 16, 48):
        _, want = jax.lax.top_k(-jnp.asarray(prio), m)
        np.testing.assert_array_equal(sched.select(ss, m).numpy(),
                                      np.asarray(want))


# names of repro.core the port leaves out: none since the sharded engine
NOT_YET: set[str] = set()


def test_import_surface_matches_repro():
    """``repro_torch.core`` exports every name of ``repro.core.__all__``
    but the sharded engine's, and ``repro_torch`` the rest of
    ``repro``'s ``_CORE_EXPORTS``; each task's default pipeline is
    ``repro``'s."""
    import repro
    import repro.core as jcore

    import repro_torch.core as tcore

    want = set(jcore.__all__) - NOT_YET
    assert set(tcore.__all__) == want
    assert not any(hasattr(tcore, n) for n in NOT_YET)
    for name in sorted(want):
        assert getattr(tcore, name) is not None, name
    for name in repro._CORE_EXPORTS:
        assert getattr(repro_torch, name) is getattr(tcore, name), name
    assert tcore.DeviceEnvPool is type(repro_torch.make("Ant-v3", 2,
                                                        device="cpu"))
    assert tcore.MeshEnvPool is type(repro_torch.make(
        "Ant-v3", 2, engine="device-sharded", num_shards=2, device="cpu"))
    assert tcore.make_env_mesh(2, "cpu").num_shards == 2
    pool = tcore.make_pool(CartPole(), 4, 2, device="cpu")
    assert (pool.mode, pool.batch_size) == ("async", 2)
    for task in jax_registry.list_envs():
        got = [type(t).__name__ for t in default_transforms(task)]
        want_names = [type(t).__name__ for t in
                      jax_registry.default_transforms(task)]
        assert got == want_names, task


def test_registered_task_streams_as_repro():
    """A task registered in both packages, CartPole under a new name with
    ``FrameStack(2)`` as its default pipeline, is listed, takes the
    pipeline and streams as ``repro``'s: 30 async steps with auto-reset,
    obs within 1e-5 (its float state, as tests/test_torch_protocol.py
    holds CartPole), the rest exact."""
    from repro.core.transforms import FrameStack as JFrameStack
    from repro.envs.classic import CartPole as JCartPole

    import repro_torch.core.registry as treg

    name = "CartPoleStack2-v1"
    jax_registry.register(name, JCartPole, (JFrameStack(2),))
    register(name, CartPole, (repro_torch.FrameStack(2),))
    try:
        assert name in repro_torch.list_envs()
        jp = jax_registry.make(name, num_envs=4, batch_size=2, obs=False)
        tp = repro_torch.make(name, num_envs=4, batch_size=2, device="cpu")
        assert tp.spec.obs_spec.shape == jp.spec.obs_spec.shape == (2, 4)
        dones = []
        rollout(jp, tp, STEPS, atol=1e-5, on_block=lambda t, jts, tts:
                dones.append(int(tts.done.sum())))
        assert sum(dones) > 0
    finally:   # the other tests see the registries as they were
        jax_registry._REGISTRY.pop(name)
        jax_registry._TRANSFORMS.pop(name)
        treg._REGISTERED.pop(name)
    assert name not in repro_torch.list_envs()
