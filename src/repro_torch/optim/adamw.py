"""AdamW with global-norm clipping, and plain SGD
(``repro/optim/adamw.py``).

Functional over a tree of tensors (``utils/tree.py``): ``update``
returns new parameters and a new state and writes into neither it was
given.  All arithmetic is float32, the bias corrections ``1 - b**count``
included, as in the JAX package; the learning rate may be a float or a
0-dim tensor (``optim/schedule.py``).  AdamW's ``update`` takes a
``norm``, where given the global norm the clip scales by: a caller that
hands ``update`` only its slice of a gradient (``rl/ppo.py``, a policy
placed across processes) passes the whole gradient's norm, since the
slice's own norm is another number.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_dataclass, tree_leaves, tree_map


@tree_dataclass
class AdamWState:
    mu: Any
    nu: Any
    count: torch.Tensor     # () int32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]


def global_norm(tree: Any) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree: Any, max_norm: float,
                        norm: torch.Tensor | None = None
                        ) -> tuple[Any, torch.Tensor]:
    """``tree`` scaled to a global norm of at most ``max_norm``, and the
    norm; ``norm`` stands in for ``tree``'s own where given."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda x: x * scale, tree), norm


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float | None = 1.0
          ) -> Optimizer:
    def init(params: Any) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        count = torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device)
        return AdamWState(mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params), count=count)

    def update(grads: Any, state: AdamWState, params: Any, lr,
               norm: torch.Tensor | None = None) -> tuple[Any, AdamWState]:
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, norm)
        count = state.count + 1
        cf = count.to(torch.float32)
        b1c = 1.0 - torch.pow(b1, cf)
        b2c = 1.0 - torch.pow(b2, cf)

        def moment1(g, m):
            return b1 * m + (1 - b1) * g.float()

        def moment2(g, n):
            gf = g.float()
            return b2 * n + (1 - b2) * gf * gf

        mu = tree_map(moment1, grads, state.mu)
        nu = tree_map(moment2, grads, state.nu)

        def step(p, m, n):
            pf = p.float()
            upd = (m / b1c) / (torch.sqrt(n / b2c) + eps) + weight_decay * pf
            return (pf - lr * upd).to(p.dtype)

        new_params = tree_map(step, params, mu, nu)
        return new_params, AdamWState(mu=mu, nu=nu, count=count)

    return Optimizer(init=init, update=update)


def sgd(lr_scale: float = 1.0, clip_norm: float | None = None) -> Optimizer:
    """Plain SGD (cheap optimizer-state option for memory-tight configs)."""

    def init(params: Any) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)

    def update(grads, state, params, lr):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        new_params = tree_map(
            lambda p, g: (p.float() - lr * lr_scale * g.float()).to(p.dtype),
            params, grads)
        return new_params, state + 1

    return Optimizer(init=init, update=update)


__all__ = ["AdamWState", "Optimizer", "adamw", "clip_by_global_norm",
           "global_norm", "sgd"]
