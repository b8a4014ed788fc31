"""Block-sparse spike matmul — the sparse engine's product.

Port of ``repro.kernels.spike_matmul.spike_matmul``: ``y = s @ w (+ b)``
for {0,1} spikes (or small integer counts) ``s: (M, K)`` against
weights ``w: (K, N)``, accumulated in fp32, skipping all-zero spike
tiles. Three functions:

* :func:`spike_matmul_plain` — the plain PyTorch version: the dense
  fp32 product (a skipped tile adds exact zeros, so skipping does not
  change the result), then the bias, rounded once to the operands'
  dtype;
* :func:`spike_matmul` — the wrapper: CPU tensors take the plain
  version, CUDA tensors launch ``csrc/spike_matmul.cu`` through
  :func:`spike_matmul_cuda` or raise;
* :func:`block_occupancy` — the TPU kernel's ``(nM, nK)`` map of live
  spike tiles (any non-zero entry per tile).

The CUDA kernel skips at its own tile, :data:`SKIP_TILE` rows by
columns of ``s``, finer than the TPU kernel's default 128 x 128; it
skips every chunk the TPU kernel would, and more, with the same result.
Both return the fp32 accumulator rounded once to the operands' dtype —
the JAX kernel's default ``out_dtype`` (``w.dtype``). The engine's
operands carry the activation dtype, so the cast that JAX's engine
applies to the kernel's fp32 output is fused into the kernel's store
(``core/engine.spike_linear``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

# kernel launches on the card (one per call of spike_matmul_cuda)
LAUNCHES = {"spike_matmul": 0}
# the CUDA kernel's skip tile of s: (rows, columns) per output tile and
# contraction chunk (csrc/spike_matmul.cu BM, BK)
SKIP_TILE = (128, 32)


def reset_launches() -> None:
    LAUNCHES["spike_matmul"] = 0


def block_occupancy(s: torch.Tensor, block_m: int, block_k: int
                    ) -> torch.Tensor:
    """(M, K) spikes -> (M / block_m, K / block_k) int32, 1 where the tile
    holds a non-zero entry. M and K must be multiples of the blocks."""
    m, k = s.shape
    occ = (s != 0).reshape(m // block_m, block_m, k // block_k, block_k)
    return occ.any(dim=3).any(dim=1).to(torch.int32)


def spike_matmul_plain(s: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernel: (M, N) ``s @ w`` (+ bias) accumulated
    in fp32, rounded once to ``s.dtype``."""
    y = s.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(s.dtype)


def spike_matmul(s: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = s @ w (+ bias) -> (M, N) in ``s.dtype``, accumulated in fp32.
    s: (M, K) {0,1} spikes or non-negative integer counts; w: (K, N);
    bias: (N,) or None."""
    if s.dim() != 2 or w.dim() != 2 or s.shape[1] != w.shape[0]:
        raise ValueError(f"spike_matmul takes s (M, K) and w (K, N), got "
                         f"{tuple(s.shape)} and {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"bias has shape {tuple(bias.shape)}, expected "
                         f"({w.shape[1]},)")
    if s.device.type == "cpu":
        return spike_matmul_plain(s, w, bias)
    if s.device.type != "cuda":
        raise ValueError(f"spike_matmul runs on CPU or CUDA tensors, not "
                         f"{s.device.type}")
    return spike_matmul_cuda(s, w, bias)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    from repro_torch.kernels import _build
    lib = _build.load("spike_matmul")
    if lib.spike_matmul_forward.argtypes is None:
        lib.spike_matmul_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.spike_matmul_forward.restype = ctypes.c_int
        lib.spike_matmul_error.argtypes = [ctypes.c_int]
        lib.spike_matmul_error.restype = ctypes.c_char_p
    return lib


def spike_matmul_cuda(s: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. s and w share
    one dtype (float32 or bfloat16), which the output takes, and are
    contiguous."""
    if s.dtype not in _DTYPES or w.dtype != s.dtype:
        raise ValueError(f"spike_matmul kernel takes s and w of one dtype, "
                         f"float32 or bfloat16, got {s.dtype} and {w.dtype}")
    operands = (s, w) if bias is None else (s, w, bias)
    for a in operands:
        if a.device != s.device:
            raise ValueError("all spike_matmul operands must be on one "
                             "device")
        if not a.is_contiguous():
            raise ValueError("spike_matmul kernel takes contiguous operands")
    m, k = s.shape
    n = w.shape[1]
    b32 = None if bias is None else bias.float().contiguous()
    out = torch.empty((m, n), dtype=s.dtype, device=s.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(s.device).cuda_stream
    rc = lib.spike_matmul_forward(
        _DTYPES[s.dtype], s.data_ptr(), w.data_ptr(),
        None if b32 is None else b32.data_ptr(), out.data_ptr(), m, k, n,
        stream)
    if rc != 0:
        raise RuntimeError(f"spike_matmul kernel launch failed: "
                           f"{lib.spike_matmul_error(rc).decode()}")
    LAUNCHES["spike_matmul"] += 1
    return out
