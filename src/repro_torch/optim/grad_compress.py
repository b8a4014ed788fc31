"""Int8 gradient compression with error feedback.

Port of ``repro.optim.grad_compress``. Each gradient leaf is quantized to
int8 with one fp32 scale for the leaf (the round trip a data-parallel
all-reduce of the int8 view would carry), and the quantization residual
is kept and added back at the next step (error feedback keeps the method
unbiased in the long run). The quantizer is the weight datapath's
(``quant.symmetric_scale`` / ``quantize_values`` / ``dequantize_values``:
per-tensor scale here, round half to even, clip to [-127, 127]).

The scale is ``max|g| / 127`` by a true division, as eager JAX computes
it; jitted XLA multiplies by the reciprocal instead, which can land the
scale an ulp apart (ROADMAP queue 3, "jitted QAT rounds its scale
apart"). So :func:`compressed_gradients` equals eager JAX bitwise.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.quant.quantize import (dequantize_values, quantize_values,
                                        symmetric_scale)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, fp32 scale): symmetric per-tensor quantization
    (scale = max|x| / 127 with an epsilon floor, round to nearest even)."""
    x32 = x.float()
    scale = symmetric_scale(x32, 8)
    return quantize_values(x32, scale, 8), scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return dequantize_values(q, scale, dtype)


def compress_state_init(params) -> Any:
    """Error-feedback residuals: fp32 zeros shaped as the params, on
    their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compressed_gradients(grads, error_state) -> Tuple[Any, Any]:
    """Int8 round trip with error feedback over a gradient tree: (the
    decompressed gradients, in each leaf's dtype, for the optimizer; the
    new fp32 residuals)."""
    out = []
    for g, e in zip(tree_leaves(grads), tree_leaves(error_state)):
        g32 = g.float() + e
        deq = int8_decompress(*int8_compress(g32))
        out.append((deq.to(g.dtype), g32 - deq))
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
