"""The port's trainer CLI, ``python -m repro_torch.launch.train``, on
the CPU (``--device cpu``), held to ``repro``'s own criteria
(tests/test_system.py):

* it learns the synthetic Markov corpus: the last logged loss is below
  the first by more than 1.0, at ``test_lm_training_learns_markov``'s
  flags;
* 40 steps straight give the loss of 20 steps, a restart from their
  checkpoint and 20 more (rtol 1e-4, as ``repro``'s test);
* SIGTERM mid-run flushes a checkpoint and exits 0, and the run started
  again from it ends with the straight run's loss (rtol 1e-4);
* without a card it refuses to start unless ``--device cpu`` is given,
  and ``--mesh debug`` names ROADMAP A19;
* ``--arch xlstm-125m --smoke`` trains as ``repro``'s CLI does (the
  same logged steps and learning rates, finite losses starting at about
  ln(vocab) and falling below it, the two within 0.1): the CLI needs no
  code of its own for the xLSTM beyond the registry entry.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one OpenMP thread a child: the suite's xdist workers share the cores
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1")
SMALL = ["--arch", "qwen3-0.6b", "--smoke", "--d-model", "64", "--layers",
         "2", "--batch", "4", "--seq", "32", "--log-every", "1",
         "--device", "cpu"]


def train(*flags, timeout=300):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *flags]
    return subprocess.run(cmd, env=ENV, capture_output=True, text=True,
                          timeout=timeout)


def history(*flags, out):
    p = train(*flags, "--out-json", out)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.load(open(out))


def loss_at(hist, step):
    return [h for h in hist if h["step"] == step][0]["loss"]


def test_cli_learns_markov(tmp_path):
    hist = history("--arch", "llama3.2-3b", "--smoke", "--d-model", "128",
                   "--layers", "2", "--steps", "150", "--batch", "16",
                   "--seq", "64", "--lr", "3e-3", "--log-every", "25",
                   "--device", "cpu", out=str(tmp_path / "h.json"))
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert [h["step"] for h in hist] == [0, 25, 50, 75, 100, 125, 149]
    assert last < first - 1.0, (first, last)


def test_cli_restart_is_deterministic(tmp_path):
    def run(steps, ckpt, out):
        return history(*SMALL, "--steps", str(steps), "--ckpt-dir", ckpt,
                       "--ckpt-every", "20", out=str(tmp_path / out))

    straight = run(40, str(tmp_path / "a"), "a.json")
    run(20, str(tmp_path / "b"), "b1.json")
    resumed = run(40, str(tmp_path / "b"), "b2.json")
    assert resumed[0]["step"] == 20
    np.testing.assert_allclose(loss_at(resumed, 39), loss_at(straight, 39),
                               rtol=1e-4)


def test_sigterm_flushes_a_checkpoint_to_resume_from(tmp_path):
    steps = ["--steps", "120"]
    straight = history(*SMALL, *steps, out=str(tmp_path / "a.json"))
    ckpt = str(tmp_path / "ck")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *SMALL, *steps,
           "--ckpt-dir", ckpt, "--ckpt-every", "1000"]
    proc = subprocess.Popen(cmd, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stdout:
            if line.startswith("{") and json.loads(line)["step"] >= 3:
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    assert "preempted: checkpoint flushed" in out
    saved = [d for d in os.listdir(ckpt) if d.startswith("step_")]
    assert len(saved) == 1
    step = int(saved[0].removeprefix("step_"))
    assert 4 <= step < 120
    resumed = history(*SMALL, *steps, "--ckpt-dir", ckpt,
                      out=str(tmp_path / "b.json"))
    assert resumed[0]["step"] == step
    np.testing.assert_allclose(loss_at(resumed, 119), loss_at(straight, 119),
                               rtol=1e-4)


def test_cli_trains_xlstm_as_repro(tmp_path):
    flags = ["--arch", "xlstm-125m", "--smoke", "--steps", "40", "--batch",
             "8", "--seq", "32", "--lr", "3e-3", "--warmup", "5",
             "--log-every", "20"]
    ours = history(*flags, "--device", "cpu", out=str(tmp_path / "t.json"))
    cmd = [sys.executable, "-m", "repro.launch.train", *flags, "--out-json",
           str(tmp_path / "j.json")]
    p = subprocess.run(cmd, env=dict(ENV, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    theirs = json.load(open(tmp_path / "j.json"))
    assert [h["step"] for h in ours] == [h["step"] for h in theirs] == [
        0, 20, 39]
    np.testing.assert_allclose([h["lr"] for h in ours],
                               [h["lr"] for h in theirs], rtol=1e-6)
    for hist in (ours, theirs):
        losses = [h["loss"] for h in hist]
        assert np.isfinite(losses).all()
        assert abs(losses[0] - np.log(512)) < 0.1, losses
        assert min(losses[1:]) < losses[0], losses
    np.testing.assert_allclose([h["loss"] for h in ours],
                               [h["loss"] for h in theirs], atol=0.1)


def test_cli_refuses_what_it_cannot_run(monkeypatch):
    from repro_torch.launch import train as cli

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="A19"):
        cli.main(["--arch", "qwen3-0.6b", "--smoke", "--mesh", "debug",
                  "--device", "cpu"])
