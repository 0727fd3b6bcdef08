"""Token environment (``repro/envs/token_env.py``), over a leading lane
dim: couples the LM policy to the EnvPool engine, the role the engines
play when the policy is a large model served Seed-RL style.

Task: *noisy copy*.  The env holds a hidden target sequence; the
observation is a context window of (prompt, emitted-so-far) tokens; the
agent earns +1 per correctly copied token.  Step cost grows with the
number of tokens emitted so far, like KV-cache-length-dependent
generation cost.

``heavy_frac``/``heavy_scale`` (``TokenSkew-v0``) draw a per-episode
cost multiplier; ``short_frac``/``len_scale`` (``TokenRagged-v0``) end an
episode after ``ep_len // len_scale`` steps with probability
``short_frac``.  Both draws come from ``fold_in``\\ s of the episode's
init key, as in the JAX package, so the streams are the same bits.
"""

from __future__ import annotations

import torch

from repro_torch import random
from repro_torch.core.specs import ArraySpec, EnvSpec
from repro_torch.envs.base import Environment
from repro_torch.utils.tree import tree_dataclass


@tree_dataclass
class TokenEnvState:
    target: torch.Tensor       # (N, ep_len) int32 hidden tokens to copy
    emitted: torch.Tensor      # (N, ep_len) int32 tokens the agent produced
    t: torch.Tensor            # (N,) int32
    rng: torch.Tensor          # (N, 2) keys
    ep_return: torch.Tensor    # (N,) f32
    reward_acc: torch.Tensor
    cost_scale: torch.Tensor   # (N,) int32 per-episode cost multiplier
    ep_len_draw: torch.Tensor  # (N,) int32 per-episode length


class TokenEnv(Environment):
    def __init__(self, vocab: int = 256, ep_len: int = 32, ctx_len: int = 64,
                 heavy_frac: float = 0.0, heavy_scale: int = 8,
                 short_frac: float = 0.0, len_scale: int = 4):
        self.vocab = int(vocab)
        self.ep_len = int(ep_len)
        self.ctx_len = int(ctx_len)
        self.heavy_frac = float(heavy_frac)
        self.heavy_scale = int(heavy_scale)
        self.short_frac = float(short_frac)
        self.len_scale = int(len_scale)
        base_max = 1 + self.ep_len // 8
        self.spec = EnvSpec(
            name="TokenEnv-copy-v0",
            obs_spec=ArraySpec((self.ctx_len,), torch.int32, 0,
                               self.vocab - 1),
            act_spec=ArraySpec((), torch.int32, 0, self.vocab - 1),
            max_episode_steps=self.ep_len,
            min_cost=1,
            max_cost=base_max * (self.heavy_scale if heavy_frac > 0 else 1),
        )

    def init_state(self, keys: torch.Tensor) -> TokenEnvState:
        n, dev = keys.shape[0], keys.device
        ks = random.split(keys)
        target = random.randint(ks[:, 1], (self.ep_len,), 0, self.vocab)
        heavy = random.uniform(random.fold_in(keys, 7)) < self.heavy_frac
        short = random.uniform(random.fold_in(keys, 11)) < self.short_frac
        short_len = max(self.ep_len // self.len_scale, 1)

        def full(value, dtype):
            return torch.full((n,), value, dtype=dtype, device=dev)

        return TokenEnvState(
            target=target,
            emitted=torch.zeros((n, self.ep_len), dtype=torch.int32,
                                device=dev),
            t=full(0, torch.int32),
            rng=ks[:, 0],
            ep_return=full(0.0, torch.float32),
            reward_acc=full(0.0, torch.float32),
            cost_scale=torch.where(heavy, self.heavy_scale, 1).to(
                torch.int32),
            ep_len_draw=torch.where(short, short_len, self.ep_len).to(
                torch.int32),
        )

    def substep(self, s: TokenEnvState, action) -> TokenEnvState:
        # only the first substep mutates; later substeps model decode cost
        is_first = s.reward_acc == 0.0
        idx = torch.clamp(s.t, 0, self.ep_len - 1).long()[:, None]
        action = action.to(torch.int32)
        correct = (action == s.target.gather(1, idx)[:, 0]).to(torch.float32)
        emitted = s.emitted.scatter(1, idx, action[:, None])
        emitted = torch.where(is_first[:, None], emitted, s.emitted)
        # tiny epsilon keeps reward_acc != 0 after the first substep
        reward = torch.where(is_first, correct + 1e-9, 0.0)
        return s.replace(emitted=emitted, reward_acc=s.reward_acc + reward)

    def step_cost(self, s: TokenEnvState, action) -> torch.Tensor:
        # decode cost grows with sequence position (KV-cache length),
        # scaled by the episode's skew multiplier
        return ((1 + s.t // 8) * s.cost_scale).to(torch.int32)

    def terminal(self, s: TokenEnvState) -> torch.Tensor:
        return s.t >= s.ep_len_draw

    def observe(self, s: TokenEnvState) -> torch.Tensor:
        """Context window: ``half`` prompt tokens (the token to copy
        revealed at slot ``half - 1``) then ``half`` emitted tokens, each
        the JAX package's ``dynamic_slice`` of the zero-padded sequence,
        written here as one masked gather."""
        half = self.ctx_len // 2
        idx = torch.clamp(s.t, 0, self.ep_len - 1).long()
        j = idx[:, None] + torch.arange(half, device=idx.device) - half
        valid = (j >= 0) & (j < self.ep_len)
        jc = torch.clamp(j, 0, self.ep_len - 1)

        def window(seq: torch.Tensor) -> torch.Tensor:
            return torch.where(valid, seq.gather(1, jc), 0)

        obs = torch.zeros((idx.shape[0], self.ctx_len), dtype=torch.int32,
                          device=idx.device)
        obs[:, :half] = window(s.target)
        obs[:, half:2 * half] = window(s.emitted)
        return obs


__all__ = ["TokenEnv", "TokenEnvState"]
