"""Functional optimizers: (init, update) pairs over param trees.

Mirrors ``repro.optim.optimizers`` term for term, so one update moves
the same params by the same amounts as the JAX package: AdamW with
b2 = 0.95, weight decay 0.1 on every leaf (BN affines and the attention
threshold included) inside the step, global-norm clipping at 1.0, fp32
moments, and the update rounded once to the param dtype. (PyTorch's own
``torch.optim.AdamW`` decays the weight outside the step and rounds
differently.) Updates return new tensors; nothing is changed in place.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from .schedule import constant_schedule

Schedule = Callable[[Any], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]  # (grads, state, params, step)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw(lr: Union[Schedule, float], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "grad_norm": torch.zeros((), dtype=torch.float32,
                                         device=dev)}

    @torch.no_grad()
    def update(grads, state, params, step):
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = global_norm(grads)
        t = torch.as_tensor(step, dtype=torch.float32) + 1.0
        lr_t = lr_fn(step)
        corr1 = 1.0 - torch.pow(b1, t)
        corr2 = 1.0 - torch.pow(b2, t)

        def upd(g, m, v, p):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            mh = m / corr1
            vh = v / corr2
            step_ = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
            return (p.float() - lr_t * step_).to(p.dtype), m, v

        out = [upd(*leaves) for leaves in zip(
            tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]), tree_leaves(params))]
        pick = lambda i: tree_unflatten(params, [o[i] for o in out])
        return pick(0), {"m": pick(1), "v": pick(2), "grad_norm": gnorm}

    return Optimizer(init, update)
