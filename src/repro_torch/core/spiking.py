"""Spiking neural dynamics: LIF neurons, surrogate gradients, binarization.

Mirrors ``repro.core.spiking``. Every op runs in the activation dtype and
rounds as PyTorch rounds it (for bf16: each product and sum is rounded
back to bf16), which is also what the CUDA kernels reproduce. The spike
keeps the ``(u - v_th) >= 0`` form of the reference; its backward is the
derivative of ``sigmoid(alpha * v)``, as in the JAX ``custom_jvp``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SpikingConfig:
    """Configuration for spiking execution of a model."""

    time_steps: int = 4          # T_s
    tau: float = 2.0             # membrane time constant; decay = 1 - 1/tau
    v_threshold: float = 1.0
    soft_reset: bool = False     # Spikingformer default: hard reset
    surrogate_alpha: float = 4.0
    attention: bool = True       # enable binary attention (the binary engine)
    attn_threshold_init: float = 0.3  # learnable Delta init for binarization
    binarize_scores: bool = True      # binarize QK^T (binary attention)
    binarize_context: bool = False    # additionally binarize (QK^T)V

    @property
    def decay(self) -> float:
        return 1.0 - 1.0 / self.tau


class _Spike(torch.autograd.Function):
    """Heaviside forward, sigmoid-surrogate backward (in the dtype of v,
    term for term the JAX jvp: ``alpha * s * (1 - s) * dv``)."""

    @staticmethod
    def forward(ctx, v, alpha):
        ctx.save_for_backward(v)
        ctx.alpha = alpha
        return (v >= 0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        alpha = ctx.alpha
        s = torch.sigmoid(alpha * v)
        return alpha * s * (1.0 - s) * g, None


def spike(v: torch.Tensor, alpha: float = 4.0) -> torch.Tensor:
    """Heaviside step ``1[v >= 0]`` in the dtype of ``v``, with the
    sigmoid surrogate gradient ``d/dv sigmoid(alpha * v)``."""
    if not (torch.is_grad_enabled() and v.requires_grad):
        return (v >= 0).to(v.dtype)
    return _Spike.apply(v, alpha)


def binarize(x: torch.Tensor, delta, alpha: float = 4.0) -> torch.Tensor:
    """Thresholded binarization ``1[(x - delta) >= 0]``; the surrogate
    gradient flows to both ``x`` and ``delta``."""
    return spike(x - delta, alpha)


def lif_step(u: torch.Tensor, x: torch.Tensor, *, decay: float, v_th: float,
             soft_reset: bool, alpha: float = 4.0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LIF update. Returns (new_membrane, spikes). The reset is
    differentiated through the spike, as JAX differentiates it."""
    u = decay * u + x
    s = spike(u - v_th, alpha)
    if soft_reset:
        u = u - s * v_th
    else:
        u = u * (1.0 - s)
    return u, s


def lif_scan(currents: torch.Tensor, cfg: SpikingConfig,
             v0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LIF dynamics over the leading time axis: ``(T, ...)`` currents ->
    (spikes ``(T, ...)``, final membrane ``(...)``)."""
    u = torch.zeros_like(currents[0]) if v0 is None else v0
    out = []
    for x in currents:
        u, s = lif_step(u, x, decay=cfg.decay, v_th=cfg.v_threshold,
                        soft_reset=cfg.soft_reset, alpha=cfg.surrogate_alpha)
        out.append(s)
    return torch.stack(out), u
