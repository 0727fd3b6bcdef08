"""Generalized Advantage Estimation (Schulman et al.), a reverse loop over
the rollout (``repro/rl/gae.py``'s reverse ``lax.scan``)."""

from __future__ import annotations

import torch


def gae(rewards: torch.Tensor,      # (T, N)
        values: torch.Tensor,       # (T, N)
        dones: torch.Tensor,        # (T, N)  done AFTER this transition
        last_values: torch.Tensor,  # (N,)
        gamma: float = 0.99, lam: float = 0.95
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages (T, N), returns (T, N))."""
    not_done = 1.0 - dones.to(torch.float32)
    advs = torch.empty_like(values)
    adv_next, v_next = torch.zeros_like(last_values), last_values
    for t in reversed(range(values.shape[0])):
        nd = not_done[t]
        delta = rewards[t] + gamma * v_next * nd - values[t]
        adv_next = delta + gamma * lam * nd * adv_next
        advs[t] = adv_next
        v_next = values[t]
    return advs, advs + values


__all__ = ["gae"]
