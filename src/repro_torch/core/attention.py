"""Spiking self-attention (SSA) primitives of the binary engine.

Mirrors ``repro.core.attention``: for spiking ``Q, K, V`` in {0,1}

    scores  = Q K^T                        (AND-popcount == binary dot)
    attn    = binarize(scores * scale, Δ)  (binary attention)
    context = attn V

with no softmax. :func:`spiking_attention` consults the engine
(:func:`~repro_torch.core.engine.resolve_binary_mode`) and routes to the
plain oracle, to the ``spike_attention`` kernel ('mxu_kernel') or to the
bit-packed ``popcount_scores`` kernel ('popcount'), which agree bitwise
on spike inputs: {0,1} dot products are exact integer counts in fp32,
all three test the threshold with the same rounding rule, and with
analog scores (``binarize_scores=False``) all three sum the context over
the keys in ascending order.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .engine import EngineConfig, get_engine, resolve_binary_mode
from .spiking import SpikingConfig


def binary_attention_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Integer spike-overlap counts in fp32: (..., Lq, d) x (..., Lk, d) ->
    (..., Lq, Lk), the AND-popcount along d."""
    return q.float() @ k.float().transpose(-1, -2)


def spiking_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: SpikingConfig, delta_score=0.0,
                      scale: Optional[float] = None, causal: bool = False,
                      engine: Optional[EngineConfig] = None) -> torch.Tensor:
    """Binary spiking attention over the last two dims ``(L, d)``.

    q, k, v: ``(..., L, d)`` spike tensors; leading dims fold into the
    binary engine's BH axis. ``scale`` defaults to 1/sqrt(d). Returns the
    context ``(..., L, d)`` in ``q.dtype``."""
    from repro_torch.kernels import ops   # lazy: kernels import core
    d, l = q.shape[-1], q.shape[-2]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    engine = engine if engine is not None else get_engine()
    mode = resolve_binary_mode(engine, q)
    if mode != "jnp":
        fold = lambda u: u.reshape(-1, l, d)
        out = ops.binary_attention(
            fold(q), fold(k), fold(v), scale=float(scale), delta=delta_score,
            causal=causal, binarize_scores=cfg.binarize_scores,
            alpha=cfg.surrogate_alpha, use_popcount=(mode == "popcount"))
        return out.reshape(q.shape)
    return ops.binary_attention_oracle(
        q, k, v, delta_score, alpha=cfg.surrogate_alpha, scale=float(scale),
        causal=causal, binarize_scores=cfg.binarize_scores)
