"""Quickstart on the PyTorch/CUDA port: the EnvPool API, as in paper §1 /
Appendix A (``examples/quickstart.py``'s steps and prints).

On the card by default (``--device cpu`` runs it on the CPU):

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

import repro_torch
from repro_torch.utils.tree import tree_leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the pools' device (cuda must be present)")
    args = ap.parse_args(argv)
    dev = args.device
    key = repro_torch.random.PRNGKey

    # ---- synchronous mode (paper A.1): gym-style ---------------------- #
    # Pong-v5's default in-engine pipeline is FrameStack(4): the env emits
    # raw 84x84 frames and the engine stacks them inside its recv (paper
    # §3.4: preprocessing lives in the engine, not Python wrappers)
    env = repro_torch.make("Pong-v5", num_envs=16, device=dev)  # sync
    ps, ts = env.reset(key(0))
    print("reset obs:", tuple(tree_leaves(ts.obs)[0].shape))  # (16, 4, 84, 84)

    # explicit pipelines: make(..., transforms=[...]), e.g. the DQN stack
    # with reward clipping and float pixels; transforms=[] gives raw frames
    tf_env = repro_torch.make(
        "Pong-v5", num_envs=4, device=dev,
        transforms=[repro_torch.FrameStack(4), repro_torch.RewardClip(),
                    repro_torch.ObsCast(torch.float32, scale=1 / 255)],
    )
    print("transformed spec:", tf_env.spec.obs_spec.shape,
          tf_env.spec.obs_spec.dtype)

    act = np.zeros(16, dtype=np.int32)
    ps, ts = env.step(ps, act, ts.env_id)
    print("step reward:", ts.reward[:4].cpu().numpy(),
          "env_id:", ts.env_id[:4].cpu().numpy())

    # every engine carries its own counters (obs/telemetry.py); stats() is
    # the one host crossing: the loop above never synced for them
    s = env.stats(ps)
    print("pool stats: recvs=%d served=%d stepped=%d occupancy=%.2f"
          % (s["recvs"], s["served"], s["stepped"], s["occupancy"]))

    # ---- asynchronous mode (paper A.3): recv/send --------------------- #
    env = repro_torch.make("Pong-v5", num_envs=16, batch_size=8, device=dev)
    handle, recv, send, step = env.xla()                 # paper Appendix E
    ps, ts = recv(handle)                                # first 8 finishers
    t0 = time.perf_counter()
    for i in range(20):
        action = env.spec.act_spec.sample(key(i, device=env.device), (8,))
        ps = send(ps, action, ts.env_id)
        ps, ts = recv(ps)
    ids = ts.env_id.cpu().numpy()                        # waits for the card
    dt = time.perf_counter() - t0
    print("async env_ids:", ids)
    print("mean step cost (frames):", float(ts.step_cost.float().mean()))
    print(f"async env steps/s: {20 * 8 / dt:.1f}")

    # ---- host thread pool (the paper-faithful C++-style engine) -------- #
    tp = repro_torch.make("CartPole-v1", engine="thread", num_envs=8,
                          batch_size=4, device=dev)
    tp.async_reset()
    out = tp.recv()
    for _ in range(10):
        out = tp.step(np.random.randint(0, 2, size=4), out["env_id"])
    print("thread pool batch:", tuple(out["obs"].shape),
          "ids:", out["env_id"].cpu().numpy())
    tp.close()
    print("OK")


if __name__ == "__main__":
    main()
