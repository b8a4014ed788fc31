"""Differentiable entries around the kernels.

Mirrors ``repro.kernels.ops``: ``binary_attention`` runs its forward
through a kernel — the fused ``spike_attention`` (the MXU mode), or with
``use_popcount=True`` the bit-packed AND-PopCount score kernel
``popcount_scores`` followed by the threshold, the causal mask and the
context product — and recomputes the backward through the plain
surrogate-gradient oracle :func:`binary_attention_oracle` (the
counterpart of ``_jnp_folded``), so the L x L attention matrix is never
kept between forward and backward. Each kernel's wrapper runs the CUDA
kernel on the card and the plain version on the CPU.
``popcount_attention_scores`` and ``lif`` are the kernel API's raw
forward entries of ``popcount_scores`` and ``lif_forward``.
"""
from __future__ import annotations

import torch

from repro_torch.core.attention import binary_attention_scores
from repro_torch.core.bitpack import pack_bits
from repro_torch.core.spiking import spike
from repro_torch.kernels.fused_ssa import (analog_context, analog_scores,
                                           threshold_scores)
from repro_torch.kernels.lif import lif_forward
from repro_torch.kernels.popcount_attention import popcount_scores
from repro_torch.kernels.spike_attention import spike_attention
from repro_torch.models.nn import fma32


def binary_attention_oracle(q, k, v, delta, *, alpha: float, scale: float,
                            causal: bool, binarize_scores: bool
                            ) -> torch.Tensor:
    """Binary attention over the last two dims ``(L, d)`` in plain
    PyTorch, differentiable through the sigmoid surrogate: scores in
    fp32, thresholded as ``fma32(scores, scale, -delta)`` (the FMA that
    jitted XLA contracts; its gradient is that of ``scores * scale -
    delta``), context in fp32, cast back to ``q.dtype``; analog scores
    ``count * scale`` are summed over the keys in ascending order
    (``fused_ssa.analog_context``, the kernels' order)."""
    if not binarize_scores:
        a = analog_scores(q, k, scale)
        return analog_context(a.tril() if causal else a, v).to(q.dtype)
    scores = binary_attention_scores(q, k)
    delta = torch.as_tensor(delta, dtype=torch.float32, device=q.device)
    a = spike(fma32(scores, scale, -delta), alpha)
    if causal:
        a = a.tril()
    return (a @ v.float()).to(q.dtype)


def _popcount_attention(q, k, v, delta, *, scale: float, causal: bool,
                        binarize_scores: bool) -> torch.Tensor:
    """The popcount mode's forward, as JAX computes it: q and k packed
    into words, one ``popcount_scores`` launch, then in plain PyTorch the
    threshold (``fma32(count, scale, -delta) >= 0``, the rule of the MXU
    kernel, which jitted XLA contracts the reference's ``count * scale -
    delta`` into) or the raw ``count * scale``, the causal mask, and the
    context as one fp32 product with v, cast to ``q.dtype``. A count is
    an integer in [0, d], so the threshold (or the analog score) of each
    of the d + 1 counts is computed once, by the same rule, and looked
    up: the same values, without float64 passes over the L x L scores.
    Analog scores are summed over the keys in ascending order
    (``fused_ssa.analog_context``), as the other two modes sum them."""
    counts = popcount_scores(pack_bits(q), pack_bits(k))
    levels = torch.arange(q.shape[-1] + 1, dtype=torch.float32,
                          device=q.device)
    table = threshold_scores(levels, scale, delta) if binarize_scores \
        else levels * scale
    a = table.index_select(0, counts.reshape(-1)).reshape(counts.shape)
    if causal:
        a = a.tril_()
    ctx = a @ v.float() if binarize_scores else analog_context(a, v)
    return ctx.to(q.dtype)


class _BinaryAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, delta, alpha, scale, causal, binarize_scores,
                use_popcount):
        ctx.save_for_backward(q, k, v, delta)
        ctx.conf = dict(alpha=alpha, scale=scale, causal=causal,
                        binarize_scores=binarize_scores)
        kernel = _popcount_attention if use_popcount else spike_attention
        return kernel(q, k, v, delta=delta, scale=scale, causal=causal,
                      binarize_scores=binarize_scores)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = binary_attention_oracle(*leaves, **ctx.conf)
            grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        return (*grads, None, None, None, None, None)


def binary_attention(q, k, v, *, scale: float, delta, alpha: float = 4.0,
                     causal: bool = False, binarize_scores: bool = True,
                     use_popcount: bool = False) -> torch.Tensor:
    """Folded-layout binary attention: q, k, v (BH, L, d) spike tensors.
    The forward runs the ``spike_attention`` kernel, or with
    ``use_popcount`` the ``popcount_scores`` kernel on the packed spikes;
    the backward recomputes the oracle with surrogate gradients and
    returns dq, dk, dv and d_delta."""
    delta = torch.as_tensor(delta, dtype=torch.float32, device=q.device)
    return _BinaryAttention.apply(q, k, v, delta, alpha, scale, causal,
                                  binarize_scores, use_popcount)


def popcount_attention_scores(q_spikes: torch.Tensor, k_spikes: torch.Tensor
                              ) -> torch.Tensor:
    """q, k (BH, L, d) {0,1} -> int32 (BH, Lq, Lk) counts: pack, then
    AND-popcount (the ``popcount_scores`` kernel)."""
    return popcount_scores(pack_bits(q_spikes), pack_bits(k_spikes))


def lif(currents: torch.Tensor, *, decay: float, v_th: float = 1.0,
        soft_reset: bool = False) -> torch.Tensor:
    """Fused LIF over (T, ..., D) currents (the ``lif_forward`` kernel):
    the middle dims fold into M. Spikes in the currents' dtype."""
    t, d = currents.shape[0], currents.shape[-1]
    out = lif_forward(currents.reshape(t, -1, d).contiguous(), decay=decay,
                      v_th=v_th, soft_reset=soft_reset)
    return out.reshape(currents.shape)
