"""The port's model-parallel steps against ``repro``'s own sharded steps,
on the CPU, over gloo ranks (tests/_torch_mesh_check.py).

For each mesh shape (1,2), (2,2) and (1,4) one job runs, at once:
``repro``'s steps jitted with ``in_shardings`` on forced host devices in
a mesh of that shape with Auto axes, and the port's steps on as many
gloo ranks over a ``DeviceMesh`` of that shape, under
``BASELINE_RULES``, on the smoke qwen3-0.6b (dense and blocked),
llama3.2-3b, starcoder2-3b (sliding, window 32) and qwen2-vl-72b (a
patch prefix and M-RoPE positions); on the (1,2) and (1,4) meshes also
granite-moe-3b-a800m (4 experts, top 2), hymba-1.5b (attention beside
the SSM), xlstm-125m and whisper-large-v3 (frames); and on the (1,4)
mesh a 6-head qwen3 whose heads the model axis does not divide and a
6-expert granite whose experts it does not divide.  Each holds:

* the gradient at the initial weights, and the parameters after three
  ``make_train_step`` steps, within 1e-4 of each leaf's largest entry;
  the three losses and MoE aux losses within 1e-4 relative;
* a prefill that fills its cache (blocked where the family has it):
  next tokens identical, logits and every cache leaf (KV rows, SSM
  state, xLSTM states, cross K/V) within 1e-4;
* 8 greedy ``make_serve_step`` steps after a prefill: identical tokens,
  final caches within 1e-4;
* on every rank, the local parameter and optimizer-state bytes equal
  ``bytes_per_device`` of the plan.

On 2 ranks, ``make_debug_mesh`` is (1, 2), and an LM policy of 2^20
params or more placed by ``place_params`` over a TokenRagged-v0 pool of
2 shards, one a process, holds half of each sharded leaf a rank
(``policy_shardings``' plan) and collects the same greedy actions as the
policy whole and as ``repro``'s, its policy placed on 2 devices;
``decode_step``'s logits within 1e-5.  The trainer CLI with ``--mesh
debug`` on 2 ranks (torchrun's environment, gloo): 40 steps straight,
and a restart from the straight run's step-20 checkpoint for the 20
more, end with bitwise the same checkpoint; on granite-moe-3b-a800m it
trains and logs its mesh.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one OpenMP thread a child: the suite's xdist workers share the cores
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
CHECK = os.path.join(ROOT, "tests", "_torch_mesh_check.py")
MESHES = ["1,2", "2,2", "1,4"]
CASES = ["qwen3-dense", "qwen3-blocked", "llama", "starcoder2", "qwen2-vl"]
# the MoE, hybrid, xLSTM and Whisper cases ride every job
# (``_torch_mesh_check.py::FAMILY_MESHES``): on (2,2) their FSDP gathers
# and reduce-scatters run
FAMILIES = ["granite", "hymba", "xlstm", "whisper"]
MESH_CASES = ([(m, c) for m in MESHES for c in CASES + FAMILIES]
              + [("1,4", "qwen3-6heads"), ("1,4", "granite-6experts")])
TOL = 1e-4
CLI = ["--arch", "qwen3-0.6b", "--smoke", "--batch", "4", "--seq", "32",
       "--steps", "40", "--warmup", "5", "--ckpt-every", "20",
       "--log-every", "10", "--mesh", "debug", "--device", "cpu"]
MOE_CLI = ["--arch", "granite-moe-3b-a800m", "--smoke", "--batch", "4",
           "--seq", "32", "--steps", "2", "--log-every", "1", "--mesh",
           "debug", "--device", "cpu"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(args, env=ENV):
    return subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def cli_ranks(args: list) -> list:
    """The trainer on 2 ranks, as torchrun would start it."""
    port = str(free_port())
    return [spawn([sys.executable, "-m", "repro_torch.launch.train", *args],
                  dict(ENV, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=port))
            for r in range(2)]


def finish(procs) -> list[str]:
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-4000:]
            outs.append(stdout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh job and the CLI's straight run at once, then the CLI's
    restart; the results by mesh."""
    tmp = tmp_path_factory.mktemp("mesh")
    jobs, procs = {}, []
    for shape in MESHES:
        out = tmp / shape.replace(",", "x")
        out.mkdir()
        world = int(np.prod([int(x) for x in shape.split(",")]))
        port = str(free_port())
        procs.append(spawn([sys.executable, CHECK, "ref", shape, str(out)]))
        procs += [spawn([sys.executable, CHECK, "rank", str(r), str(world),
                         port, shape, str(out)]) for r in range(world)]
        jobs[shape] = (out, world)
    straight = str(tmp / "straight")
    moe = cli_ranks(MOE_CLI)
    finish(cli_ranks(CLI + ["--ckpt-dir", straight]))
    resumed = str(tmp / "resumed")
    os.makedirs(resumed)
    shutil.copytree(os.path.join(straight, "step_20"),
                    os.path.join(resumed, "step_20"))
    logs = finish(cli_ranks(CLI + ["--ckpt-dir", resumed]))
    moe_logs = finish(moe)
    finish(procs)
    res = {}
    for shape, (out, world) in jobs.items():
        res[shape] = {
            "ref": dict(np.load(out / "ref.npz")),
            "port": dict(np.load(out / "port.npz")),
            "ranks": [json.load(open(out / f"rank{r}.json"))
                      for r in range(world)]}
    res["cli"] = {"straight": os.path.join(straight, "step_40"),
                  "resumed": os.path.join(resumed, "step_40"),
                  "log": logs[0], "moe_logs": moe_logs}
    return res


def entries(d: dict, case: str, kind: str) -> dict:
    prefix = f"{case}/{kind}"
    return {k[len(prefix):]: v for k, v in d.items()
            if k.startswith(prefix)}


def assert_leaves_close(got: dict, want: dict, tol: float) -> None:
    """Each leaf within ``tol`` times the largest entry of ``want``'s."""
    assert got.keys() == want.keys() and want
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, (name, err)


@pytest.mark.parametrize("shape,case", MESH_CASES)
def test_train_steps_match_repro(runs, shape, case):
    ref, port = runs[shape]["ref"], runs[shape]["port"]
    np.testing.assert_allclose(port[f"{case}/loss"], ref[f"{case}/loss"],
                               rtol=TOL, atol=0)
    np.testing.assert_allclose(port[f"{case}/aux"], ref[f"{case}/aux"],
                               rtol=TOL, atol=0)
    if case.startswith("granite"):
        assert (ref[f"{case}/aux"] > 0).all()
    assert_leaves_close(entries(port, case, "grad"),
                        entries(ref, case, "grad"), TOL)
    assert_leaves_close(entries(port, case, "params"),
                        entries(ref, case, "params"), TOL)


@pytest.mark.parametrize("shape,case", MESH_CASES)
def test_blocked_prefill_matches_repro(runs, shape, case):
    ref, port = runs[shape]["ref"], runs[shape]["port"]
    key = f"{case}/prefill"
    np.testing.assert_array_equal(port[key + ".tokens"], ref[key + ".tokens"])
    np.testing.assert_allclose(port[key + ".logits"], ref[key + ".logits"],
                               rtol=TOL, atol=TOL)
    assert_leaves_close(entries(port, case, "prefill.cache"),
                        entries(ref, case, "prefill.cache"), TOL)


@pytest.mark.parametrize("shape,case", MESH_CASES)
def test_serve_steps_match_repro(runs, shape, case):
    ref, port = runs[shape]["ref"], runs[shape]["port"]
    key = f"{case}/serve"
    np.testing.assert_array_equal(port[key + ".tokens"], ref[key + ".tokens"])
    assert port[key + ".tokens"].shape == (8, 4)
    assert_leaves_close(entries(port, case, "serve.cache"),
                        entries(ref, case, "serve.cache"), TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_microbatched_train_step_matches_unsharded(runs, shape):
    """Two steps of the blocked qwen3 in 2 microbatches: each slice laid
    out on the batch's plan again, the same losses and parameters as the
    unsharded step (which tests/test_torch_train_lm.py holds to
    ``repro``'s microbatches)."""
    port = runs[shape]["port"]
    np.testing.assert_allclose(port["qwen3-blocked/mb_sharded_loss"],
                               port["qwen3-blocked/mb_plain_loss"],
                               rtol=TOL, atol=0)
    assert_leaves_close(entries(port, "qwen3-blocked", "mb_sharded_params"),
                        entries(port, "qwen3-blocked", "mb_plain_params"),
                        TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_each_rank_holds_bytes_per_device(runs, shape):
    world = int(np.prod([int(x) for x in shape.split(",")]))
    ranks = runs[shape]["ranks"]
    assert len(ranks) == world
    for report in ranks:
        for case, parts in report["bytes"].items():
            for part, (local, planned) in parts.items():
                assert local == planned, (case, part, local, planned)
    # the (2,2) and (1,4) plans shard more than the (1,2) one
    if world == 4:
        two = runs["1,2"]["ranks"][0]["bytes"]["llama"]["params"][0]
        assert ranks[0]["bytes"]["llama"]["params"][0] < two


def test_debug_mesh_and_unported_families_refuse(runs):
    """Every family runs on the mesh now (the cases above); on 2 ranks
    ``make_debug_mesh`` is (1, 2)."""
    for report in runs["1,2"]["ranks"]:
        assert report["debug_mesh"] == [["data", "model"], [1, 2]]


def test_policy_placed_across_processes_matches_repro(runs):
    ref, port = runs["1,2"]["ref"], runs["1,2"]["port"]
    for report in runs["1,2"]["ranks"]:
        policy = report["policy"]
        assert policy["params"] >= 1 << 20 and policy["sharded_leaves"] > 0
        held, planned = policy["bytes"]
        assert held == planned, (held, planned)
    np.testing.assert_array_equal(port["policy/actions"],
                                  ref["policy/actions"])
    np.testing.assert_array_equal(port["policy/whole_actions"],
                                  ref["policy/actions"])
    assert port["policy/actions"].shape == (6, 4)
    np.testing.assert_allclose(port["policy/logits"], ref["policy/logits"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(port["policy/logits"],
                               port["policy/whole_logits"], rtol=0,
                               atol=1e-5)


def test_every_registry_arch_runs_the_sharded_steps(runs):
    """The cases cover eight of the registry's ten archs against
    ``repro``; the (1,2) ranks run the other two (qwen3-14b, dbrx-132b:
    a dense and an MoE decoder, whose code the cases hold) sharded
    against unsharded: the same tokens, parameters within 1e-4 of each
    leaf's largest entry after a step."""
    from repro_torch.configs import list_archs

    port = runs["1,2"]["port"]
    archs = {"qwen3-0.6b", "llama3.2-3b", "starcoder2-3b", "qwen2-vl-72b",
             "granite-moe-3b-a800m", "hymba-1.5b", "xlstm-125m",
             "whisper-large-v3"}
    other = {k.split("/")[0] for k in port if k.endswith("/plain_tokens")}
    assert other == {"qwen3-14b", "dbrx-132b"}
    assert archs | other == set(list_archs())
    for arch in other:
        np.testing.assert_array_equal(port[f"{arch}/sharded_tokens"],
                                      port[f"{arch}/plain_tokens"])
        assert_leaves_close(entries(port, arch, "sharded_params"),
                            entries(port, arch, "plain_params"), TOL)


def test_cli_mesh_debug_trains_an_moe_model(runs):
    for rank, log in enumerate(runs["cli"]["moe_logs"]):
        assert "mesh={'data': 1, 'model': 2}" in log
        assert f"rank={rank}" in log
        losses = [json.loads(line)["loss"] for line in log.splitlines()
                  if line.startswith("{")]
        assert len(losses) == 2 and np.isfinite(losses).all()


def test_cli_mesh_debug_resumes_bitwise(runs):
    cli = runs["cli"]
    assert "restored checkpoint step 20" in cli["log"]
    assert "mesh={'data': 1, 'model': 2}" in cli["log"]
    names = sorted(f for f in os.listdir(cli["straight"])
                   if f.endswith(".npy"))
    assert names == sorted(f for f in os.listdir(cli["resumed"])
                           if f.endswith(".npy"))
    assert any("params__layers__attn__wq" in n for n in names)
    for name in names:
        a = np.load(os.path.join(cli["straight"], name))
        b = np.load(os.path.join(cli["resumed"], name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
