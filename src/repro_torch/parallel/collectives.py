"""The explicit collectives of the SPMD ranks, over a mesh's axes
(``launch/mesh.Mesh``): where GSPMD would insert a collective into JAX's
program, the port's model code calls one of these, so every one is
visible and counted (:data:`COUNTS`, :data:`BYTES`).

* :func:`all_gather` — a leaf's shards along one dimension, in the
  axis' coordinate order (an FSDP weight over 'data' once a layer; the
  vocab-sharded logits over 'model'; the slots over 'data');
* :func:`all_reduce` — the sum over an axis of every rank's tensor, in
  its dtype, added in coordinate order, so every rank holds the same
  bits whatever the backend's reduction order (a row-split product's
  partial sums over 'model'; MoE's expert combine);
* :func:`pmean` — :func:`all_reduce` divided by the axis size.

With the gloo backend a CUDA tensor is staged through the host (gloo's
own route for device tensors): ranks that share one card reach each
other only through host memory. NCCL takes device tensors as they are.
A collective over an axis of size 1 returns its input and counts
nothing."""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map
from .sharding import spec_axes, spec_entries

# collective calls and the bytes each rank sent, by kind
COUNTS = {"all_gather": 0, "all_reduce": 0}
BYTES = {"all_gather": 0, "all_reduce": 0}

Axes = Union[str, Sequence[str]]


def reset_counts() -> None:
    for table in (COUNTS, BYTES):
        for k in table:
            table[k] = 0


def _gather_list(x: torch.Tensor, mesh, axes: Axes):
    """Every rank's ``x`` along ``axes``, in coordinate order (the first
    axis major), where the backend left them (the host for gloo); None
    when the axes have size 1."""
    group, n = mesh.group(axes)
    if n == 1:
        return None
    staged = x.detach().contiguous()
    if mesh.backend == "gloo" and staged.is_cuda:
        staged = staged.cpu()
    parts = [torch.empty_like(staged) for _ in range(n)]
    dist.all_gather(parts, staged, group=group)
    return parts


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    """The shards of every rank along ``axes`` concatenated along
    ``dim``."""
    parts = _gather_list(x, mesh, axes)
    if parts is None:
        return x
    COUNTS["all_gather"] += 1
    BYTES["all_gather"] += x.numel() * x.element_size()
    return torch.cat(parts, dim=dim).to(x.device)


def all_reduce(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The sum over ``axes`` in ``x``'s dtype, added on ``x``'s device in
    coordinate order (identical bits on every rank)."""
    parts = _gather_list(x, mesh, axes)
    if parts is None:
        return x
    COUNTS["all_reduce"] += 1
    BYTES["all_reduce"] += x.numel() * x.element_size()
    out = parts[0].to(x.device)
    for t in parts[1:]:
        out = out + t.to(x.device)
    return out


def pmean(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The mean over ``axes`` (JAX's ``pmean``: the sum, divided by the
    number of ranks)."""
    _, n = mesh.group(axes)
    return all_reduce(x, mesh, axes) / n if n > 1 else x


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A leaf's full (logical) value from the ranks' slices under
    ``spec``: an all-gather along every sharded dimension."""
    for d, part in enumerate(spec_entries(spec, x.ndim)):
        axes = tuple(a for a in spec_axes(part) if a in mesh.axis_names)
        if axes:
            x = all_gather(x, mesh, axes, d)
    return x


def gather_tree(tree, spec_tree, mesh):
    """The full tree on every rank from its slices (the inverse of
    ``sharding.shard_put``): what a checkpoint stores."""
    return tree_map(lambda x, s: gather_leaf(x, s, mesh), tree, spec_tree)
