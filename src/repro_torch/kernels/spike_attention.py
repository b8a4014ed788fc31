"""Fused binary spiking attention — the binary engine's kernel.

Port of ``repro.kernels.spike_attention.spike_attention``: for {0,1}
spike tensors ``q, k, v: (BH, L, d)``

    scores = (q k^T) * scale,  a = 1[scores - delta >= 0]  (or the raw
    scores with ``binarize_scores=False``),  causal mask,  out = a v,

in one pass and with no softmax. Three functions:

* :func:`spike_attention_plain` — the plain PyTorch version (the
  counterpart of ``repro.kernels.ref.spike_attention_ref``);
* :func:`spike_attention` — the wrapper: CPU tensors take the plain
  version, CUDA tensors launch ``csrc/spike_attention.cu`` through
  :func:`spike_attention_cuda` or raise. The kernel takes any BH, L and
  d (both products on the tensor cores; keys and values streamed from
  the operands, one launch a call).

The threshold is the reference's rounding rule: jitted XLA (and the
Pallas kernel, whose interpret mode runs jitted) contracts ``scores *
scale - delta`` into one fused multiply-add, so both versions test
``fma32(count, scale, -delta) >= 0`` (``kernels/fused_ssa.binary_scores``).
Analog scores ``fl(count * scale)`` are summed over the keys in ascending
order, one fp32 add a term, by the kernel and the plain version alike
(``kernels/fused_ssa.analog_context``), so the two agree bitwise, and
with the SSA bundle's analog context; XLA sums in its own order, so the
reference agrees within ``L * d * scale * 2^-23``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fused_ssa import (analog_context, analog_scores,
                                           binary_scores)

# kernel launches on the card (one per call of spike_attention_cuda; the
# CUDA kernel, csrc/spike_attention.cu, takes any BH, L and d)
LAUNCHES = {"spike_attention": 0}


def reset_launches() -> None:
    LAUNCHES["spike_attention"] = 0


def spike_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, delta, causal: bool = False,
                          binarize_scores: bool = True) -> torch.Tensor:
    """Plain version: (BH, L, d) context in ``q.dtype``, accumulated in
    fp32 (analog scores in ascending key order, as the kernel)."""
    if not binarize_scores:
        a = analog_scores(q, k, scale)
        return analog_context(a.tril() if causal else a, v).to(q.dtype)
    a = binary_scores(q, k, scale, delta)
    if causal:
        a = a.tril()
    return (a @ v.float()).to(q.dtype)


def spike_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, delta, causal: bool = False,
                    binarize_scores: bool = True) -> torch.Tensor:
    """q, k, v: (BH, L, d) {0,1} spike tensors of one dtype; delta: the
    threshold (a float or a 1-element tensor). Returns the (BH, L, d)
    context in ``q.dtype``. The kernel reads any non-zero entry as a
    spike: the operands must be {0,1}, as the JAX kernel requires."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"spike_attention takes q, k, v of one (BH, L, d) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        return spike_attention_plain(q, k, v, scale=scale, delta=delta,
                                     causal=causal,
                                     binarize_scores=binarize_scores)
    if q.device.type != "cuda":
        raise ValueError(f"spike_attention runs on CPU or CUDA tensors, not "
                         f"{q.device.type}")
    return spike_attention_cuda(q, k, v, scale=scale, delta=delta,
                                causal=causal,
                                binarize_scores=binarize_scores)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    from repro_torch.kernels import _build
    lib = _build.load("spike_attention")
    if lib.spike_attention_forward.argtypes is None:
        lib.spike_attention_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_float]
            + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
        lib.spike_attention_forward.restype = ctypes.c_int
        lib.spike_attention_error.argtypes = [ctypes.c_int]
        lib.spike_attention_error.restype = ctypes.c_char_p
    return lib


def spike_attention_cuda(q, k, v, *, scale: float, delta, causal: bool = False,
                         binarize_scores: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"spike_attention kernel takes q, k, v of one dtype, "
                         f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    for a in (k, v):
        if a.device != q.device:
            raise ValueError("all spike_attention operands must be on one "
                             "device")
    for a in (q, k, v):
        if not a.is_contiguous():
            raise ValueError("spike_attention kernel takes contiguous "
                             "operands")
    bh, l, d = q.shape
    delta_t = torch.as_tensor(delta, dtype=torch.float32, device=q.device
                              ).reshape(1).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.spike_attention_forward(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        delta_t.data_ptr(), float(scale), int(causal), int(binarize_scores),
        bh, l, d, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"spike_attention kernel launch failed: "
                           f"{lib.spike_attention_error(rc).decode()}")
    LAUNCHES["spike_attention"] += 1
    return out
