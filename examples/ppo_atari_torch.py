"""End-to-end PPO on the Atari-like env (paper §4.2 / Figure 6), on the
PyTorch/CUDA port (``examples/ppo_atari.py``'s arguments and prints).

The default task is ``PongClassic-v5``: the env renders native
210x160x3 RGB screens through the render kernel, and the engine runs the
classic DQN preprocessing (``Grayscale`` -> ``Resize(84, 84)``, the
image kernels, -> ``FrameStack(4)`` -> ``RewardClip``) inside its recv,
so PPO trains on the stacked 4x84x84 stream with no pixel leaving the
card.  ``--raw`` drops the task's preset pipeline.

Default settings mirror the paper's CleanRL Atari config (Table 3, N=8);
``--tuned`` switches to the high-throughput Figure-6 settings (N=64,
larger batch, fewer epochs).  On the card by default (``--device cpu``
trains on the CPU):

    PYTHONPATH=src python examples/ppo_atari_torch.py --total-steps 100000
    PYTHONPATH=src python examples/ppo_atari_torch.py --tuned
"""

import argparse
import json

import repro_torch
from repro_torch.rl.ppo import PPOConfig, train_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="PongClassic-v5",
                    help="registered task; the default runs the RGB "
                         "render + Grayscale/Resize classic pipeline")
    ap.add_argument("--total-steps", type=int, default=100_000)
    ap.add_argument("--num-envs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--tuned", action="store_true",
                    help="paper Fig.6 high-throughput settings (N=64)")
    ap.add_argument("--num-steps", type=int, default=128,
                    help="rollout length per iteration (smaller = faster "
                         "smoke runs)")
    ap.add_argument("--raw", action="store_true",
                    help="drop the task's preset pipeline and train on "
                         "raw observations")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the pool's and learner's device (cuda must be "
                         "present)")
    args = ap.parse_args(argv)

    if args.tuned:
        num_envs, batch = 64, 64
        cfg = PPOConfig(total_steps=args.total_steps,
                        num_steps=args.num_steps,
                        minibatches=4, epochs=2, lr=8e-4, ent_coef=0.01,
                        vf_clip=False)
    else:
        num_envs = args.num_envs
        batch = args.batch_size or num_envs
        cfg = PPOConfig(total_steps=args.total_steps,
                        num_steps=args.num_steps,
                        minibatches=4, epochs=4, lr=2.5e-4)

    # the registry preset is the preprocessing config: for PongClassic-v5
    # Grayscale -> Resize(84,84) -> FrameStack(4) -> RewardClip, inside
    # the engine's recv
    kw = {"transforms": []} if args.raw else {}
    pool = repro_torch.make(args.task, num_envs=num_envs, batch_size=batch,
                            engine="device", device=args.device, **kw)
    print(f"[ppo_atari] task={args.task} obs_spec="
          f"{pool.spec.obs_spec.shape} pipeline="
          f"{[type(t).__name__ for t in pool.pipeline.transforms]}",
          flush=True)

    def log(rec):
        print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                          for k, v in rec.items()}), flush=True)

    state, net, hist = train_device(pool, cfg, seed=args.seed, log_fn=log)
    last = hist[-1]
    print(f"[ppo_atari] env steps/s: "
          f"{last['env_steps'] / last['time_s']:.1f}", flush=True)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(hist, f)


if __name__ == "__main__":
    main()
