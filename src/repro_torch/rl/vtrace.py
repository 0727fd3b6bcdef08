"""V-trace off-policy advantage estimation (Espeholt et al. 2018, IMPALA;
``repro/rl/vtrace.py``).

The pipelined drivers (``rl/ppo.py::train_pipelined``,
``train_host_pipelined``) consume rollouts collected behind an older
policy, one policy step stale in ``train_pipelined``.  V-trace re-weights
the behavior policy's TD errors toward the target policy's with
truncated importance weights:

    rho_t = min(rho_clip, pi(a_t|x_t) / mu(a_t|x_t))
    c_t   = lam * min(c_clip, pi(a_t|x_t) / mu(a_t|x_t))
    v_t   = V(x_t) + delta_t + gamma c_t (v_{t+1} - V(x_{t+1}))
    delta_t = rho_t (r_t + gamma V(x_{t+1}) - V(x_t))

with the policy-gradient advantage ``rho_t (r_t + gamma v_{t+1} -
V(x_t))``.  When behavior and target coincide (every ratio 1, the clips
inactive) ``vs - values`` is GAE(lam)'s advantage.  ``dones`` cuts the
bootstrap as GAE's ``not_done`` does.  The JAX package's reverse
``lax.scan`` is a reverse loop over T here, in the same order, written
into a preallocated ``(T, N)`` buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VTraceReturns(NamedTuple):
    vs: torch.Tensor             # (T, N) corrected value targets
    pg_advantages: torch.Tensor  # (T, N) rho-clipped policy-gradient advs


def vtrace(
    behavior_logp: torch.Tensor,    # (T, N) log mu(a_t | x_t) at collect
    target_logp: torch.Tensor,      # (T, N) log pi(a_t | x_t), the learner
    rewards: torch.Tensor,          # (T, N)
    values: torch.Tensor,           # (T, N) V(x_t) under the learner
    dones: torch.Tensor,            # (T, N) done AFTER this transition
    bootstrap_value: torch.Tensor,  # (N,)  V(x_T) under the learner
    gamma: float = 0.99,
    lam: float = 1.0,
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
) -> VTraceReturns:
    """Returns ``(vs, pg_advantages)``, both ``(T, N)``: the value
    targets and the policy loss's advantages."""
    not_done = 1.0 - dones.to(torch.float32)
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp_max(ratio, rho_clip)
    c = lam * torch.clamp_max(ratio, c_clip)

    values_next = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    delta = rho * (rewards + gamma * values_next * not_done - values)

    dv = torch.empty_like(delta)
    acc = torch.zeros_like(bootstrap_value)
    for t in reversed(range(delta.shape[0])):
        acc = delta[t] + gamma * not_done[t] * c[t] * acc
        dv[t] = acc
    vs = values + dv
    vs_next = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = rho * (rewards + gamma * vs_next * not_done - values)
    return VTraceReturns(vs=vs, pg_advantages=pg_adv)


__all__ = ["VTraceReturns", "vtrace"]
