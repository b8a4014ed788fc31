"""The SSA bundle's sequential oracle (``repro.kernels.fused_ssa.
reference_bundle``): Q/K/V projections with fp32 accumulation -> BN
affine (``bn`` family) or RoPE on q and k (``rope`` family) -> LIF ->
binary attention, causal or not. The fused bundle kernel itself is still
to be ported (ROADMAP queue 2 #6)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.spiking import SpikingConfig, lif_scan
from repro_torch.models.nn import bn_affine, fma32, rope_rotate


def binary_scores(q: torch.Tensor, k: torch.Tensor, scale: float,
                  delta) -> torch.Tensor:
    """``1[(q k^T) * scale - delta >= 0]`` in fp32. XLA contracts the
    scale and the threshold into one FMA, so the threshold is tested on
    the once-rounded ``fma32(score, scale, -delta)``; scores of {0,1}
    spikes are exact integer counts."""
    scores = q.float() @ k.float().transpose(-1, -2)
    neg = -torch.as_tensor(delta, dtype=torch.float32, device=q.device)
    return (fma32(scores, scale, neg) >= 0).float()


def rope_heads(y: torch.Tensor, table: torch.Tensor, num_heads: int
               ) -> torch.Tensor:
    """RoPE on each head of (T, B, L, H*hd) with the (2, L, hd/2)
    [cos; sin] table (``nn.rope_rotate``'s rounding), back in y's dtype."""
    t, b, l, qd = y.shape
    y5 = y.reshape(t, b, l, num_heads, qd // num_heads)
    return rope_rotate(y5, table[0][:, None, :], table[1][:, None, :]
                       ).to(y.dtype).reshape(t, b, l, qd)


def reference_bundle(x: torch.Tensor, w3: torch.Tensor,
                     scale3: Optional[torch.Tensor], aux: torch.Tensor,
                     delta, scfg: SpikingConfig, *, family: str,
                     num_heads: int, head_dim: int, scale: float,
                     causal: bool = False, eps: float = 1e-5
                     ) -> torch.Tensor:
    """x: (T, B, L, D) spikes (bn) or normed currents (rope); w3:
    (3, D, H*hd); aux: (3, 4, H*hd) BN rows [mean, var, scale, bias] (bn)
    or the (2, L, hd/2) [cos; sin] table (rope). Returns the context
    (T, B, L, H*hd)."""
    if family not in ("bn", "rope"):
        raise ValueError(f"unknown bundle family {family!r}")
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
        if family == "bn":
            y = bn_affine(y.float(), aux[j, 0], torch.rsqrt(aux[j, 1] + eps),
                          aux[j, 2], aux[j, 3]).to(x.dtype)
        elif j < 2:                                  # rope on q, k
            y = rope_heads(y, aux, num_heads)
        projected.append(lif_scan(y, scfg)[0])
    q, k, v = (u.reshape(t * b, l, num_heads, head_dim).transpose(1, 2)
               for u in projected)
    attn = binary_scores(q, k, scale, delta)
    if causal:
        attn = attn.tril()
    ctx = (attn @ v.float()).to(q.dtype)
    return ctx.transpose(1, 2).reshape(t, b, l, q_dim)
