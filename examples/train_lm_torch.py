"""End-to-end LM training on the PyTorch/CUDA port: trains the synthetic
Markov corpus on any dense --arch at ``examples/train_lm.py``'s presets,
with checkpoints, through ``python -m repro_torch.launch.train``.

On the card by default; ``--device cpu`` trains on the CPU:

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen3-0.6b \\
        --preset demo [--device cpu]
"""

import argparse
import os
import subprocess
import sys
import tempfile

PRESETS = {
    # d_model, layers, steps, batch, seq
    "smoke": dict(d=64, layers=2, steps=30, batch=4, seq=64),
    "demo": dict(d=256, layers=4, steps=300, batch=8, seq=128),
    "100m": dict(d=768, layers=12, steps=300, batch=8, seq=512),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--preset", default="demo", choices=sorted(PRESETS))
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    p = PRESETS[args.preset]

    cmd = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", args.arch, "--smoke",
        "--d-model", str(p["d"]), "--layers", str(p["layers"]),
        "--steps", str(p["steps"]), "--batch", str(p["batch"]),
        "--seq", str(p["seq"]), "--lr", "1e-3",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--log-every", "20", "--device", args.device,
    ]
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.path.join(root, "src")
    raise SystemExit(subprocess.call(cmd, env=env))


if __name__ == "__main__":
    main()
