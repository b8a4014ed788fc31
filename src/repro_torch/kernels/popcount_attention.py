"""Bit-packed AND-PopCount attention scores — the binary engine's
faithful FPGA mode (``binary='popcount'``).

Port of ``repro.kernels.popcount_attention.popcount_scores``: for
bit-packed spikes ``q_packed: (BH, Lq, W)`` and ``k_packed: (BH, Lk,
W)`` (``core/bitpack.pack_bits``'s layout, 32-bit words held in int32
tensors as the uint32 pattern) the int32 counts

    out[b, i, j] = sum_w popcount(q_packed[b, i, w] & k_packed[b, j, w]),

``(BH, Lq, Lk)``: the overlap of each query and key, which FireFly-T
computes with LUT6 compressor trees. Three functions:

* :func:`popcount_scores_plain` — the plain PyTorch version (the
  counterpart of ``repro.kernels.ref.popcount_scores_ref``);
* :func:`popcount_scores` — the wrapper: CPU tensors take the plain
  version, CUDA tensors launch ``csrc/popcount_attention.cu`` through
  :func:`popcount_scores_cuda` or raise.

Lq and Lk are any lengths: the JAX wrapper zero-pads them to its blocks
and slices the result back; the CUDA kernel writes the counts of all
heads as one flat stream of 16-byte stores, so no shape is ragged to it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bitpack import popcount_matmul

# kernel launches on the card (one per call of popcount_scores_cuda)
LAUNCHES = {"popcount_scores": 0}


def reset_launches() -> None:
    LAUNCHES["popcount_scores"] = 0


def popcount_scores_plain(q_packed: torch.Tensor, k_packed: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version: (BH, Lq, Lk) int32 AND-popcount counts."""
    return popcount_matmul(q_packed, k_packed)


def _check(q_packed: torch.Tensor, k_packed: torch.Tensor) -> None:
    if q_packed.dim() != 3 or k_packed.dim() != 3 or \
            q_packed.shape[0] != k_packed.shape[0] or \
            q_packed.shape[2] != k_packed.shape[2]:
        raise ValueError(f"popcount_scores takes (BH, Lq, W) and (BH, Lk, W) "
                         f"words, got {tuple(q_packed.shape)} and "
                         f"{tuple(k_packed.shape)}")
    if q_packed.dtype != torch.int32 or k_packed.dtype != torch.int32:
        raise ValueError(f"popcount_scores takes int32 words (the uint32 "
                         f"pattern of pack_bits), got {q_packed.dtype} and "
                         f"{k_packed.dtype}")


def popcount_scores(q_packed: torch.Tensor, k_packed: torch.Tensor
                    ) -> torch.Tensor:
    """(BH, Lq, W) x (BH, Lk, W) int32 words -> (BH, Lq, Lk) int32
    counts."""
    _check(q_packed, k_packed)
    if q_packed.device.type == "cpu":
        return popcount_scores_plain(q_packed, k_packed)
    if q_packed.device.type != "cuda":
        raise ValueError(f"popcount_scores runs on CPU or CUDA tensors, not "
                         f"{q_packed.device.type}")
    return popcount_scores_cuda(q_packed, k_packed)


def _library():
    from repro_torch.kernels import _build
    lib = _build.load("popcount_attention")
    if lib.popcount_scores_forward.argtypes is None:
        lib.popcount_scores_forward.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 2)
        lib.popcount_scores_forward.restype = ctypes.c_int
        lib.popcount_scores_error.argtypes = [ctypes.c_int]
        lib.popcount_scores_error.restype = ctypes.c_char_p
    return lib


def popcount_scores_cuda(q_packed: torch.Tensor, k_packed: torch.Tensor
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check(q_packed, k_packed)
    if k_packed.device != q_packed.device:
        raise ValueError("popcount_scores operands must be on one device")
    if not (q_packed.is_contiguous() and k_packed.is_contiguous()):
        raise ValueError("popcount_scores kernel takes contiguous operands")
    bh, lq, w = q_packed.shape
    lk = k_packed.shape[1]
    out = torch.empty((bh, lq, lk), dtype=torch.int32,
                      device=q_packed.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(q_packed.device).cuda_stream
    rc = lib.popcount_scores_forward(q_packed.data_ptr(), k_packed.data_ptr(),
                                     bh, lq, lk, w, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"popcount_scores kernel launch failed: "
                           f"{lib.popcount_scores_error(rc).decode()}")
    LAUNCHES["popcount_scores"] += 1
    return out
