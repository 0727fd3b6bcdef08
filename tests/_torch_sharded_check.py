"""Subprocess helper for tests/test_torch_sharded.py: the port's sharded
engine against ``repro``'s at D shards.

The suite runs ``repro`` on ONE device (tests/conftest.py), so this
runs in a fresh interpreter that forces D host devices before jax is
imported, as tests/_sharded_check.py does.  Each case resets both
packages' pools from one seed, steps them with the same routed actions
and compares every block (tests/_torch_pair.py), then ``stats()``
bitwise; it prints one JSON object, ``{case: "ok" or the failure}``.
At D = 2 it also runs one iteration of ``train_device`` and
``train_pipelined`` in both packages, and one of ``train_device`` over
PongClassic-v5 with the default CNN, which ``repro``'s
``policy_shardings`` shards over the two host devices.

Usage: python tests/_torch_sharded_check.py D
"""

import json
import sys
import traceback

from repro.launch.mesh import force_host_device_count

D = int(sys.argv[1]) if len(sys.argv) > 1 else 2
force_host_device_count(D)

import numpy as np  # noqa: E402

import repro.core.engine as jengine  # noqa: E402
import repro.core.registry as jax_registry  # noqa: E402
from repro_torch.core.engine import MeshEnvPool  # noqa: E402
from repro_torch.core.registry import _registry  # noqa: E402

from _torch_pair import assert_stats_equal, make_pair, rollout  # noqa: E402

NORM_ATOL = 1e-3

# (task, N, M, schedule, atol, steps, make's keywords); each at D shards
EPISODE = {"max_episode_steps": 6}
CASES = [
    ("Ant-v3", 8, None, "fifo", 1e-4, 10, EPISODE),
    ("Ant-v3", 8, 4, "fifo", 1e-4, 10, EPISODE),
    ("CartPole-v1", 8, 4, "sjf", 1e-5, 12, EPISODE),
    ("AntSkew-v3", 8, 4, "hierarchical", 1e-4, 20,
     {**EPISODE, "sched_patience": 0.25}),
    ("AntSkew-v3", 8, None, "hierarchical", 1e-4, 8, EPISODE),
    ("TokenCopy-v0", 8, 4, "hierarchical", 0.0, 10, {}),
    ("PongClassic-v5", 4, None, "fifo", 0.0, 6, EPISODE),
    ("PongClassic-v5", 8, 4, "sjf", 0.0, 6, EPISODE),
    ("AntNorm-v3", 8, None, "fifo", NORM_ATOL, 6, EPISODE),
    ("AntNorm-v3", 8, 4, "hierarchical", NORM_ATOL, 8, EPISODE),
]


def moments_close(jps, tps):
    """NormalizeObs' moments: every shard's copy within 1e-6."""
    for k in ("count", "mean", "m2"):
        got = tps.tf_state[0][k].numpy()
        want = np.asarray(jps.tf_state[0][k])
        assert got.shape == want.shape, (k, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def pair_case(task, n, m, schedule, atol, steps, kw):
    jp, tp = make_pair(task, n, m, engine="device-sharded", num_shards=D,
                       schedule=schedule, **kw)
    assert tp.num_shards == jp.num_shards == D
    jps, tps = rollout(jp, tp, steps, seed=3, atol=atol)
    assert_stats_equal(jp.stats(jps), tp.stats(tps), task)
    if task == "AntNorm-v3":
        moments_close(jps, tps)
    return tp.stats(tps)


def masked_case():
    """``mode="masked"`` on the mesh engine (``make`` has no sharded
    masked engine; the class takes it, as ``repro``'s does)."""
    jp = jengine.MeshEnvPool(jax_registry._jax_env("AntSkew-v3",
                                                   max_episode_steps=5),
                             8, 4, mode="masked", mesh=D)
    tp = MeshEnvPool(_registry()["AntSkew-v3"][0](max_episode_steps=5),
                     8, 4, mode="masked", mesh=D, device="cpu")
    jps, tps = rollout(jp, tp, 12, seed=2, atol=1e-4)
    assert_stats_equal(jp.stats(jps), tp.stats(tps), "masked")
    assert tp.masked_ticks > 0


def _flat(params):
    """Sorted-key leaves of a params dict as float64 numpy arrays."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _flat(params[k])]
    return [np.asarray(params, np.float64)]


def train_case(driver: str) -> dict:
    """One iteration of ``driver`` over Ant-v3 N=8 at D shards in both
    packages: the largest parameter difference and the history's."""
    import repro.rl.ppo as jppo
    import repro_torch.rl.ppo as tppo

    jp, tp = make_pair("Ant-v3", 8, None, engine="device-sharded",
                       num_shards=D)
    out = {}
    for name, ppo, pool in (("repro", jppo, jp), ("port", tppo, tp)):
        cfg = ppo.PPOConfig(total_steps=8 * 8, num_steps=8, epochs=2,
                            minibatches=2)
        state, _, hist = getattr(ppo, driver)(pool, cfg, seed=1,
                                              hidden=(16, 16))
        params = state.params
        if name == "port":
            params = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                          if isinstance(v, dict) else v.numpy())
                      for k, v in params.items()}
        out[name] = (_flat(params), hist[0])
    (jflat, jh), (tflat, th) = out["repro"], out["port"]
    return {"params": max(float(np.abs(a - b).max())
                          for a, b in zip(jflat, tflat)),
            "history": max(abs(jh[k] - th[k]) for k in jh if k != "time_s")}


def cnn_case() -> dict:
    """One iteration of ``train_device`` over PongClassic-v5 N=4 at D
    shards with the default CNN in both packages: how many of
    ``repro``'s param leaves are sharded, the largest difference of the
    final params (``repro``'s through ``params_from_jax``, conv weights
    to OIHW) and the largest of each history metric over
    ``test_torch_ppo.py``'s bound, ``1e-4 * |repro's| + 1e-6``."""
    import jax

    import repro.rl.ppo as jppo
    import repro_torch.rl.ppo as tppo
    from repro_torch.rl.nets import params_from_jax
    from repro_torch.utils.tree import tree_leaves_with_path

    jp, tp = make_pair("PongClassic-v5", 4, None, engine="device-sharded",
                       num_shards=D)
    cfg = dict(total_steps=4 * 8, num_steps=8, epochs=2, minibatches=2)
    js, _, jh = jppo.train_device(jp, jppo.PPOConfig(**cfg), seed=1)
    ts, _, th = tppo.train_device(tp, tppo.PPOConfig(**cfg), seed=1)
    want = dict(tree_leaves_with_path(params_from_jax(
        jax.tree.map(np.asarray, js.params), "cpu")))
    got = dict(tree_leaves_with_path(ts.params))
    assert got.keys() == want.keys()
    return {
        "sharded_leaves": sum(not x.sharding.is_fully_replicated
                              for x in jax.tree.leaves(js.params)),
        "params": max(float((got[k] - want[k]).abs().max()) for k in got),
        "history": {k: max(abs(j[k] - t[k]) / (1e-4 * abs(j[k]) + 1e-6)
                           for j, t in zip(jh, th))
                    for k in ("loss", "pg", "vf", "ent", "ratio")}}


def main() -> dict:
    res = {}
    for driver in ("train_device", "train_pipelined") if D == 2 else ():
        try:
            res[driver] = train_case(driver)
        except Exception:  # noqa: BLE001
            res[driver] = traceback.format_exc(limit=3)[-1500:]
    if D == 2:
        try:
            res["cnn"] = cnn_case()
        except Exception:  # noqa: BLE001
            res["cnn"] = traceback.format_exc(limit=3)[-1500:]
    for case in CASES:
        name = "-".join(str(c) for c in case[:4])
        try:
            stats = pair_case(*case)
            res[name] = "ok"
            if case[0] == "AntSkew-v3" and case[2] is not None:
                res["overdue_admits"] = stats["overdue_admits"]
        except Exception:  # noqa: BLE001 - reported to the parent
            res[name] = traceback.format_exc(limit=3)[-1500:]
    try:
        masked_case()
        res["masked"] = "ok"
    except Exception:  # noqa: BLE001
        res["masked"] = traceback.format_exc(limit=3)[-1500:]
    return res


if __name__ == "__main__":
    print(json.dumps(main()))
