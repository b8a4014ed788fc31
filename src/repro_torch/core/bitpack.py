"""Bit-packing of binary spike tensors into 32-bit words.

Port of ``repro.core.bitpack``. A word keeps the JAX package's uint32
bit pattern in an int32 tensor: PyTorch's ``torch.uint32`` has no shift
on this build, and int32 holds the same 32 bits. Bit ``j`` of word ``w``
is element ``w * 32 + j`` (little-endian bits); bit 31 is the sign bit
of the int32 view. Population counts use the SWAR reduction on the
words widened to int64, since PyTorch has no popcount operator and the
widening keeps every shift logical.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

WORD = 32


def pad_to_multiple(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to the next multiple of ``mult``."""
    axis = axis % x.ndim
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """``(..., n)`` binary values -> ``(..., ceil(n / 32))`` words (int32
    holding the uint32 pattern); the last word is zero-padded."""
    x = pad_to_multiple(x, -1, WORD)
    bits = (x != 0).to(torch.int64).reshape(*x.shape[:-1], -1, WORD)
    shifts = torch.arange(WORD, dtype=torch.int64, device=x.device)
    words = (bits << shifts).sum(dim=-1)             # in [0, 2^32)
    return torch.where(words >= 1 << 31, words - (1 << 32), words
                       ).to(torch.int32)


def unpack_bits(p: torch.Tensor, n: int, dtype=torch.float32
                ) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``(..., ceil(n/32))`` words ->
    ``(..., n)`` (padding bits dropped)."""
    if -(-n // WORD) != p.shape[-1]:
        raise ValueError(f"n={n} inconsistent with packed shape "
                         f"{tuple(p.shape)}")
    shifts = torch.arange(WORD, dtype=torch.int32, device=p.device)
    bits = (p.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*p.shape[:-1], -1)[..., :n].to(dtype)


def _popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR on the int64 widening)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def popcount_matmul(a_packed: torch.Tensor, b_packed: torch.Tensor
                    ) -> torch.Tensor:
    """Binary matmul by AND + population count: (..., M, W) x (..., N, W)
    words -> (..., M, N) int32 counts, equal to ``a @ b.T`` on the
    unpacked {0,1} arrays."""
    anded = a_packed[..., :, None, :] & b_packed[..., None, :, :]
    return _popcount_words(anded).sum(dim=-1, dtype=torch.int32)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Total number of set bits of a packed array."""
    return _popcount_words(x).sum(dtype=torch.int32)
