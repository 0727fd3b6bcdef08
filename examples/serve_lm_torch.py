"""Scheduler-fed continuous-batching LM decode server on the pool's lane
machinery, on the PyTorch/CUDA port (``examples/serve_lm.py``'s
arguments and prints; ``serving/decode_pool.py`` + ``rl/policy_lm.py``).

A fixed block of decode lanes serves a queue of requests with ragged
prompt and generation lengths.  Each request is admitted into a free
lane (its prompt prefilled through the same cached one-token-per-step
program the hot loop runs), decodes one token per step against its
static per-lane KV cache through the ``decode_attention`` kernel, and
leaves the block the moment it finishes.  The run-to-completion baseline
(``--static``) admits a new batch only when every lane has drained.

On the card by default (``--device cpu`` runs it on the CPU):

    PYTHONPATH=src python examples/serve_lm_torch.py --lanes 8 --requests 32
    PYTHONPATH=src python examples/serve_lm_torch.py --static   # the baseline
    PYTHONPATH=src python examples/serve_lm_torch.py --schedule sjf
"""

import argparse

import numpy as np
import torch

from repro_torch.core.specs import ArraySpec, EnvSpec
from repro_torch.rl.policy_lm import LMPolicy, default_policy_config
from repro_torch.serving import DecodePool


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=8,
                    help="decode-block width (lanes decoding in lockstep)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="max prompt length (ragged, 4..this)")
    ap.add_argument("--max-new", type=int, default=48,
                    help="long-request generation budget")
    ap.add_argument("--short-frac", type=float, default=0.75,
                    help="fraction of requests generating max-new/4 tokens")
    ap.add_argument("--schedule", default="fifo", choices=["fifo", "sjf"])
    ap.add_argument("--static", action="store_true",
                    help="run-to-completion static batches instead of "
                         "continuous batching")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the server's device (cuda must be present)")
    args = ap.parse_args(argv)

    max_len = args.prompt_len + args.max_new + 1
    spec = EnvSpec(
        name="serve-lm",
        obs_spec=ArraySpec((2,), torch.int32, 0, args.vocab - 1),
        act_spec=ArraySpec((), torch.int32, 0, args.vocab - 1),
        max_episode_steps=max_len,
    )
    policy = LMPolicy(spec, default_policy_config(args.vocab, max_len),
                      max_len=max_len, device=args.device)
    params = policy.init(torch.Generator(policy.device).manual_seed(
        args.seed))

    rng = np.random.default_rng(args.seed)
    prompts = [
        list(rng.integers(0, args.vocab, rng.integers(4, args.prompt_len + 1)))
        for _ in range(args.requests)
    ]
    budgets = [
        max(args.max_new // 4, 1) if rng.random() < args.short_frac
        else args.max_new
        for _ in range(args.requests)
    ]

    pool = DecodePool(policy, num_lanes=args.lanes, max_new=args.max_new,
                      schedule=args.schedule)
    mode = "static (run-to-completion)" if args.static else "continuous"
    # a first serve warms the kernels and allocator, so the reported
    # numbers are steady-state
    pool.serve(params, prompts[: args.lanes], continuous=not args.static,
               max_new=budgets[: args.lanes])
    outputs, stats = pool.serve(params, prompts,
                                continuous=not args.static,
                                max_new=budgets)
    assert [len(o) for o in outputs] == budgets
    print(f"mode={mode} schedule={args.schedule} lanes={args.lanes} "
          f"requests={stats.requests}")
    print(f"decoded {stats.total_tokens} tokens in {stats.decode_steps} "
          f"block steps ({stats.wall_s*1e3:.0f} ms)")
    print(f"lane utilization {stats.utilization:.1%}  "
          f"throughput {stats.tokens_per_s:,.0f} tok/s")


if __name__ == "__main__":
    main()
