"""Quantization-aware training: fake-quant with a straight-through
gradient.

Port of ``repro.quant.qat``. ``fake_quant`` runs the serving quantizer's
rounding (per-output-channel symmetric scales, round half to even) in
fp32 and hands back the dequantized weight in its own dtype; its
backward passes the cotangent through unchanged (the straight-through
estimator), so the optimizer keeps moving the fp masters. A
``quantize_tree`` of the trained masters then serves exactly the weights
the loss saw. ``launch/steps.build_train_step(cfg, opt, qat='int8')``
applies :func:`fake_quant_tree` inside the loss.
"""
from __future__ import annotations

from typing import Any

import torch

from .quantize import (INT_BITS, _is_linear_params, dequantize_values,
                       map_param_dicts, quantize_values, symmetric_scale)


class _FakeQuant(torch.autograd.Function):
    """Forward: quantize -> dequantize (the serving rounding); backward:
    the identity (STE)."""

    @staticmethod
    def forward(ctx, w, bits):
        scale = symmetric_scale(w, bits, axis=-2)[..., None, :]
        return dequantize_values(quantize_values(w, scale, bits), scale,
                                 w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-output-channel symmetric quantize -> dequantize of a (..., K,
    N) weight in fp32, returned in ``w.dtype``; identity gradient."""
    return _FakeQuant.apply(w, bits)


def fake_quant_tree(params: Any, dtype: str = "int8") -> Any:
    """Fake-quantize the ``"w"`` of every linear of a param tree (the
    nodes ``quantize_tree`` quantizes: 2-D and scan-stacked 3-D weights);
    convs, norms, biases and embeddings pass through. Differentiable:
    gradients reach the masters through the STE."""
    bits = INT_BITS[dtype]
    return map_param_dicts(
        params, _is_linear_params,
        lambda path, node: {k: (fake_quant(v, bits) if k == "w" else v)
                            for k, v in node.items()})
