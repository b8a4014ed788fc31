"""The SSA bundle's sequential oracle (``repro.kernels.fused_ssa.
reference_bundle``), ``bn`` family: Q/K/V projections with fp32
accumulation -> BN affine -> LIF -> binary attention. The fused bundle
kernel itself is still to be ported (ROADMAP queue 2 #6)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.spiking import SpikingConfig, lif_scan
from repro_torch.models.nn import bn_affine, fma32


def binary_scores(q: torch.Tensor, k: torch.Tensor, scale: float,
                  delta) -> torch.Tensor:
    """``1[(q k^T) * scale - delta >= 0]`` in fp32. XLA contracts the
    scale and the threshold into one FMA, so the threshold is tested on
    the once-rounded ``fma32(score, scale, -delta)``; scores of {0,1}
    spikes are exact integer counts."""
    scores = q.float() @ k.float().transpose(-1, -2)
    neg = -torch.as_tensor(delta, dtype=torch.float32, device=q.device)
    return (fma32(scores, scale, neg) >= 0).float()


def reference_bundle(x: torch.Tensor, w3: torch.Tensor,
                     scale3: Optional[torch.Tensor], aux: torch.Tensor,
                     delta, scfg: SpikingConfig, *, family: str,
                     num_heads: int, head_dim: int, scale: float,
                     eps: float = 1e-5) -> torch.Tensor:
    """x: (T, B, L, D) spikes; w3: (3, D, H*hd); aux: (3, 4, H*hd) BN rows
    [mean, var, scale, bias]. Returns the context (T, B, L, H*hd)."""
    if family != "bn":
        raise NotImplementedError(
            "the rope family is not ported to PyTorch yet (ROADMAP queue 1 "
            "item 7)")
    if not scfg.binarize_scores:
        raise NotImplementedError(
            "analog attention scores are not ported to PyTorch yet")
    t, b, l, _ = x.shape
    q_dim = num_heads * head_dim
    projected = []
    for j in range(3):
        acc = x.float() @ w3[j].float()
        if scale3 is not None:
            acc = acc * scale3[j].float()
        y = acc.to(x.dtype)
        y = bn_affine(y.float(), aux[j, 0], torch.rsqrt(aux[j, 1] + eps),
                      aux[j, 2], aux[j, 3]).to(x.dtype)
        projected.append(lif_scan(y, scfg)[0])
    q, k, v = (u.reshape(t * b, l, num_heads, head_dim).transpose(1, 2)
               for u in projected)
    attn = binary_scores(q, k, scale, delta)
    ctx = (attn @ v.float()).to(q.dtype)
    return ctx.transpose(1, 2).reshape(t, b, l, q_dim)
