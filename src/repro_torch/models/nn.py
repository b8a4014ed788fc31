"""Functional NN layers (the subset the spiking vision models and the
spiking LM use).

Mirrors ``repro.models.nn``: params are nested dicts of tensors made by
``*_init`` functions from a ``torch.Generator``; activations keep the
JAX package's layouts at the public functions (NHWC images, HWIO conv
weights, ``(d_in, d_out)`` linear weights).

Two numerics rules keep the port bitwise with the jitted reference:

* :func:`fma32` — XLA contracts an fp32 ``a * b + c`` into one fused
  multiply-add (BN's affine, the binary-attention threshold). The port
  computes it as a float64 product plus a float64 sum, rounded once to
  fp32; the CUDA kernels use the same definition, so kernel and plain
  version agree by construction.
* the BN inverse std is ``torch.rsqrt(var + eps)``, computed once per
  channel. It differs from XLA's rsqrt by one or two ulp on about a
  third of inputs, which tests avoid by drawing variances where the two
  agree.

RoPE follows the jitted reference's contraction too: XLA computes
``x1 * cos - x2 * sin`` as ``fma(x1, cos, -(x2 * sin))`` and ``x2 * cos
+ x1 * sin`` as ``fma(x2, cos, x1 * sin)``. Its cos / sin table is
taken in float64 and rounded once, the same on every device; it differs
from XLA's fp32 cos / sin by one ulp on about 1% of entries, and
:func:`rmsnorm`'s rsqrt is the rsqrt gap above, so the token family is
held against JAX within a stated tolerance.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once (float64 product and sum)."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float32, device=a.device)
               .double() for v in (a, b, c))
    return (a * b + c).float()


def bn_affine(y32: torch.Tensor, mean, inv_std, scale, bias) -> torch.Tensor:
    """The eval BatchNorm affine on fp32 values: ``(y - mean) * inv_std``
    rounded, then ``* scale + bias`` as one fused multiply-add."""
    return fma32((y32 - mean) * inv_std, scale, bias)


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32) * std
            ).to(dtype)


def linear_init(gen, d_in: int, d_out: int, *, bias: bool = False,
                std=None, dtype=torch.bfloat16):
    std = 1.0 / math.sqrt(d_in) if std is None else std
    p = {"w": normal(gen, (d_in, d_out), std, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def linear(p, x: torch.Tensor, *, spikes: bool = False,
           counts: bool = False) -> torch.Tensor:
    """Linear layer in the activation dtype (fp32 accumulation).

    ``spikes=True`` marks a {0,1} spike input (``counts=True``: the
    integer counts binary attention emits); with an engine installed such
    call sites go through the sparse engine's dispatch
    (``core.engine.spike_linear``). Otherwise this is the plain dense
    path."""
    if "qw" in p:
        # quantized dicts: spike inputs take the engine's dispatch, analog
        # inputs the weight-only quantized reference
        from repro_torch.core import engine as _engine  # lazy: no cycle
        if spikes and _engine.get_engine() is not None:
            return _engine.spike_linear(p, x, counts=counts)
        return _engine.dense_quant_linear(p, x)
    if spikes:
        from repro_torch.core import engine as _engine  # lazy: no cycle
        if _engine.get_engine() is not None:
            return _engine.spike_linear(p, x, counts=counts)
    y = (x.float() @ p["w"].float()).to(x.dtype)
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype=torch.bfloat16):
    return {"scale": torch.ones((d,), dtype=dtype)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def embedding_init(gen, vocab: int, d: int, dtype=torch.bfloat16):
    return {"table": normal(gen, (vocab, d), 1.0 / math.sqrt(d), dtype)}


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ p["table"].to(x.dtype).float().t()


def mlp_init(gen, d_model: int, d_ff: int, *, gated: bool,
             dtype=torch.bfloat16):
    p = {"up": linear_init(gen, d_model, d_ff, dtype=dtype),
         "down": linear_init(gen, d_ff, d_model, dtype=dtype)}
    if gated:
        p["gate"] = linear_init(gen, d_model, d_ff, dtype=dtype)
    return p


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each ``positions.shape + (head_dim // 2,)`` fp32: the
    angles ``pos * theta^(-i / half)`` in fp32 as the reference forms
    them, their cos and sin in float64 rounded once."""
    half = head_dim // 2
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32),
                      -torch.arange(half, dtype=torch.float32) / half)
    ang = positions.float()[..., None] * freqs.to(positions.device)
    ang = ang.double()
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope_rotate(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> torch.Tensor:
    """The rotation on fp32 halves, with the reference's contraction:
    ``[fma(x1, cos, -(x2 sin)), fma(x2, cos, x1 sin)]``."""
    half = y.shape[-1] // 2
    x1, x2 = y[..., :half].float(), y[..., half:].float()
    return torch.cat([fma32(x1, cos, -(x2 * sin)),
                      fma32(x2, cos, x1 * sin)], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Apply RoPE. x: (B, L, H, D); positions: (B, L) or (L,)."""
    positions = torch.as_tensor(positions, device=x.device)
    if positions.ndim == 1:
        positions = positions[None]
    cos, sin = rope_table(positions, x.shape[-1], theta)
    return rope_rotate(x, cos[:, :, None, :], sin[:, :, None, :]
                       ).to(x.dtype)


def batchnorm_init(d: int, dtype=torch.bfloat16):
    return {"scale": torch.ones((d,), dtype=dtype),
            "bias": torch.zeros((d,), dtype=dtype)}


def batchnorm_state_init(d: int):
    return {"mean": torch.zeros((d,), dtype=torch.float32),
            "var": torch.ones((d,), dtype=torch.float32)}


def batchnorm(p, state, x: torch.Tensor, *, train: bool = False,
              momentum: float = 0.9, eps: float = 1e-5):
    """BN over all leading axes; returns (y, new_state).

    Train mode normalises with the batch mean and population variance
    (``unbiased=False``, as ``jnp.var``) and differentiates through them;
    the running stats become ``momentum * old + (1 - momentum) * batch``,
    contracted as XLA contracts it (``fma32(momentum, old, (1 - momentum)
    * batch)``), and carry no gradient (JAX returns them as aux)."""
    x32 = x.float()
    if train:
        axes = tuple(range(x.ndim - 1))
        mu = x32.mean(dim=axes)
        var = x32.var(dim=axes, unbiased=False)
        with torch.no_grad():
            new_state = {k: fma32(state[k], momentum, (1 - momentum) * v)
                         for k, v in (("mean", mu), ("var", var))}
    else:
        mu, var = state["mean"], state["var"]
        new_state = state
    y = bn_affine(x32, mu, torch.rsqrt(var + eps), p["scale"].float(),
                  p["bias"].float())
    return y.to(x.dtype), new_state


def conv2d_init(gen, c_in: int, c_out: int, ksize: int = 3,
                dtype=torch.bfloat16):
    std = 1.0 / math.sqrt(c_in * ksize * ksize)
    return {"w": normal(gen, (ksize, ksize, c_in, c_out), std, dtype)}


def conv2d(p, x: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 conv in fp32. x: (B, H, W, C) NHWC; w: HWIO."""
    w = p["w"].float().permute(3, 2, 0, 1)              # OIHW
    kh, kw = w.shape[2:]
    pad = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)
    xc = F.pad(x.float().permute(0, 3, 1, 2), pad)
    # the reference convolves in full fp32; cuDNN would default to TF32.
    # The scope turns TF32 off for this call only and passes the other
    # cuDNN settings through as the caller left them.
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(xc, w)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 VALID max pool on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1)
