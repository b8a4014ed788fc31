"""Differentiable entries around the kernels.

Mirrors ``repro.kernels.ops``: ``binary_attention`` runs the
``spike_attention`` kernel forward (its wrapper: the CUDA kernel on the
card, the plain version on the CPU) and recomputes the backward through
the plain surrogate-gradient oracle :func:`binary_attention_oracle` (the
counterpart of ``_jnp_folded``), so the L x L attention matrix is never
kept between forward and backward.
"""
from __future__ import annotations

import torch

from repro_torch.core.attention import binary_attention_scores
from repro_torch.core.spiking import spike
from repro_torch.kernels.spike_attention import spike_attention
from repro_torch.models.nn import fma32


def binary_attention_oracle(q, k, v, delta, *, alpha: float, scale: float,
                            causal: bool, binarize_scores: bool
                            ) -> torch.Tensor:
    """Binary attention over the last two dims ``(L, d)`` in plain
    PyTorch, differentiable through the sigmoid surrogate: scores in
    fp32, thresholded as ``fma32(scores, scale, -delta)`` (the FMA that
    jitted XLA contracts; its gradient is that of ``scores * scale -
    delta``), context in fp32, cast back to ``q.dtype``."""
    scores = binary_attention_scores(q, k)
    if binarize_scores:
        delta = torch.as_tensor(delta, dtype=torch.float32, device=q.device)
        a = spike(fma32(scores, scale, -delta), alpha)
    else:
        a = scores * scale
    if causal:
        a = a.tril()
    return (a @ v.float()).to(q.dtype)


class _BinaryAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, delta, alpha, scale, causal, binarize_scores):
        ctx.save_for_backward(q, k, v, delta)
        ctx.conf = dict(alpha=alpha, scale=scale, causal=causal,
                        binarize_scores=binarize_scores)
        return spike_attention(q, k, v, scale=scale, delta=delta,
                               causal=causal, binarize_scores=binarize_scores)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = binary_attention_oracle(*leaves, **ctx.conf)
            grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        return (*grads, None, None, None, None)


def binary_attention(q, k, v, *, scale: float, delta, alpha: float = 4.0,
                     causal: bool = False, binarize_scores: bool = True,
                     use_popcount: bool = False) -> torch.Tensor:
    """Folded-layout binary attention: q, k, v (BH, L, d) spike tensors.
    The forward runs the ``spike_attention`` kernel; the backward
    recomputes the oracle with surrogate gradients and returns dq, dk, dv
    and d_delta."""
    if use_popcount:
        raise NotImplementedError(
            "the bit-packed popcount score kernel (binary='popcount') is not "
            "ported to PyTorch yet (ROADMAP queue 2 #8)")
    delta = torch.as_tensor(delta, dtype=torch.float32, device=q.device)
    return _BinaryAttention.apply(q, k, v, delta, alpha, scale, causal,
                                  binarize_scores)
