"""Logical-axis sharding rules (MaxText-style) and param-tree spec
assignment, as ``repro.parallel.sharding``.

The JAX package is single-controller GSPMD: a spec tells XLA how to lay a
global array out. The port is SPMD over processes, one a mesh position
(``launch/mesh.py``): a spec says which slice of a leaf each rank holds
(:func:`shard_put`), and the model code runs on those slices with explicit
collectives (``parallel/collectives.py``). The tables and the spec
arithmetic are the same, so the port's spec trees equal JAX's leaf by
leaf.

Production meshes (launch/mesh.py): single-pod (data=16, model=16),
multi-pod (pod=2, data=16, model=16).

Default logical rules:
  batch   -> ('pod', 'data')   (DP; pod folds into DP)
  fsdp    -> 'data'            (param / optimizer FSDP shard axis)
  model   -> 'model'           (TP: heads / d_ff / vocab / experts)
  seq     -> None              (sequence replicated; SP shards it)
"""
from __future__ import annotations

import re
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_map

_state = threading.local()


class PartitionSpec:
    """A leaf's layout: one entry a dimension, each None (replicated), a
    mesh axis name, or a tuple of names (sharded over their product).
    Tuple-like (iteration, length, indexing) and equal to any sequence
    with the same entries, JAX's ``PartitionSpec`` included. Not a tuple,
    so the port's tree helpers treat it as a leaf."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self):
        return len(self._parts)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PartitionSpec(*self._parts[i])
        return self._parts[i]

    def __eq__(self, other):
        try:
            return self._parts == tuple(other)
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self._parts)

    def __repr__(self):
        return f"PartitionSpec{self._parts!r}"


P = PartitionSpec


DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "model": "model",
    "seq": None,
    "seq_shard": "data",   # sequence-parallel shard (long-context KV)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
}


def set_rules(rules: Optional[Dict[str, Any]]) -> None:
    _state.rules = rules


def get_rules() -> Optional[Dict[str, Any]]:
    return getattr(_state, "rules", None)


class use_rules:
    """Context manager installing logical -> mesh axis rules."""

    def __init__(self, rules: Optional[Dict[str, Any]]):
        self.rules = rules

    def __enter__(self):
        self.prev = get_rules()
        set_rules(self.rules)
        return self.rules

    def __exit__(self, *exc):
        set_rules(self.prev)


def _mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names) if mesh is not None else ()


def logical_spec(names: Sequence[Optional[str]],
                 rules: Optional[Dict[str, Any]] = None, mesh=None) -> P:
    """Translate logical axis names to a spec under ``rules``. Mesh axes
    absent from ``mesh`` are dropped (a single-pod mesh ignores 'pod'),
    and an axis used twice keeps only its first occurrence."""
    rules = rules if rules is not None else (get_rules() or {})
    avail = set(_mesh_axes(mesh))
    used: set = set()
    parts = []
    for name in names:
        axes = rules.get(name) if name else None
        if axes is None:
            parts.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if (not avail or a in avail)
                     and a not in used)
        used.update(axes)
        parts.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return P(*parts)  # keep positional trailing Nones


def rules_for_mesh(mesh, **overrides) -> Dict[str, Any]:
    """DEFAULT_RULES bound to a concrete mesh."""
    rules = dict(DEFAULT_RULES, **overrides)
    rules["_mesh"] = mesh
    return rules


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """JAX's ``with_sharding_constraint`` by logical names. The port has no
    compiler to hint: a rank's tensors are already its slices, and the
    collectives sit in the model code. Returns ``x``, as JAX's does
    outside a mesh."""
    return x


# ---------------------------------------------------------------------------
# Parameter spec assignment by path patterns
# ---------------------------------------------------------------------------


def _axis_sizes(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def fit_spec_to_shape(spec, shape, mesh) -> P:
    """Right-align a spec to ``shape`` and drop mesh axes that don't divide
    the dimension (vocab 51865 cannot shard 16-way; 25 heads cannot shard
    over model=16: they stay replicated on that dim)."""
    ndim = len(shape)
    parts = list(spec)
    if len(parts) > ndim:
        parts = parts[len(parts) - ndim:]
    if len(parts) < ndim:
        parts = [None] * (ndim - len(parts)) + parts
    sizes = _axis_sizes(mesh)
    out = []
    for dim, part in zip(shape, parts):
        if part is None:
            out.append(None)
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        kept, prod = [], 1
        for a in axes:
            n = sizes.get(a, None)
            if n is None and sizes:
                continue
            n = n or 1
            if dim % (prod * n) == 0:
                kept.append(a)
                prod *= n
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def tree_map_with_path(fn, tree: Any, *rest: Any, path: str = "") -> Any:
    """:func:`repro_torch.tree.tree_map` with each leaf's ``a/b/c`` path
    (dict keys and list indices, as JAX's key paths print) first."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=f"{path}/{i}" if path else str(i))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def param_specs(params: Any, pattern_rules: Sequence[Tuple[str, P]],
                default: P = P(), mesh=None) -> Any:
    """Map a param tree to specs via ordered regex path rules (first match
    wins), each right-aligned to its leaf's rank (stacked layers add a
    leading axis that stays unsharded) and fitted to ``mesh``."""
    compiled = [(re.compile(rx), spec) for rx, spec in pattern_rules]

    def assign(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        for rx, spec in compiled:
            if rx.search(path):
                return fit_spec_to_shape(spec, shape, mesh)
        return fit_spec_to_shape(default, shape, mesh)

    return tree_map_with_path(assign, params)


def filter_spec_for_mesh(spec, mesh) -> P:
    """Drop mesh-axis references that don't exist in ``mesh``."""
    avail = set(mesh.axis_names)
    parts = []
    for part in spec:
        if part is None:
            parts.append(None)
        elif isinstance(part, str):
            parts.append(part if part in avail else None)
        else:
            kept = tuple(a for a in part if a in avail)
            parts.append(kept if len(kept) > 1 else
                         (kept[0] if kept else None))
    return P(*parts)


def spec_axes(part) -> Tuple[str, ...]:
    """A spec entry's mesh axes: () for None, one name, or the tuple."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def spec_entries(spec, ndim: int) -> list:
    """A spec's entries padded with None to ``ndim`` (a fitted spec pops
    its trailing Nones)."""
    parts = list(spec)
    return parts + [None] * (ndim - len(parts))


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's slice of a leaf of ``shape`` under ``spec``."""
    sizes = _axis_sizes(mesh)
    out = []
    for dim, part in zip(shape, spec_entries(spec, len(shape))):
        n = 1
        for a in spec_axes(part):
            n *= sizes.get(a, 1)
        out.append(dim // n)
    return tuple(out)


def local_slice(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of a full ``leaf`` under ``spec`` (a view): along
    each sharded dimension the chunk of the rank's coordinate over the
    entry's axes, the first axis major."""
    sizes = _axis_sizes(mesh)
    out = leaf
    for d, part in enumerate(spec_entries(spec, leaf.ndim)):
        axes = [a for a in spec_axes(part) if a in sizes]
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            idx = idx * sizes[a] + mesh.coords[a]
            n *= sizes[a]
        size = leaf.shape[d] // n
        out = out.narrow(d, idx * size, size)
    return out


def shard_put(tree: Any, spec_tree: Any, mesh) -> Any:
    """The host -> mesh hand-off: every rank keeps its slice of each full
    leaf (:func:`local_slice`), as a tensor of its own on the mesh's
    device; the full leaf can then be freed."""
    spec_tree = tree_map(lambda s: filter_spec_for_mesh(s, mesh), spec_tree)
    return tree_map(
        lambda x, s: local_slice(x, s, mesh).to(mesh.device, copy=True)
        .contiguous(), tree, spec_tree)
