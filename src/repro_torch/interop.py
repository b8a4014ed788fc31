"""Conversion of param and state trees between the JAX package and the
port, through numpy leaves.

The trees have the same layout on both sides (HWIO conv weights,
per-layer block and LM layer leaves stacked on a leading axis, the LM's
embedding table, ``final_norm`` and ``lm_head``), so conversion is leaf
by leaf and keeps dtypes: fp32, quantized ``qw`` codes (int8, or uint8
packed int4) beside their fp32 ``scale``, int32 cache tags. bfloat16
leaves travel as their 16-bit patterns, and uint32 leaves (the packed
KV cache's words) become int32 tensors with the same bit pattern, the
port's word type. No JAX import is needed: leaves are anything
``numpy.asarray`` takes.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map


def _leaf_to_torch(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).to(dev)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree: Any, *, device: DeviceLike = None) -> Any:
    """JAX / numpy tree -> tree of tensors on ``device`` (the GPU by
    default)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_to_torch(a, dev), tree)


def to_numpy(tree: Any) -> Any:
    """Tree of tensors -> tree of numpy arrays (dtypes kept)."""
    return tree_map(_leaf_to_numpy, tree)
