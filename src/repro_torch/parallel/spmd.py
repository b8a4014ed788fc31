"""The model code on a mesh: what a rank's step needs to run a decoder
on its slices of the params and cache.

A :class:`MeshScope` (installed by the server with :class:`use_mesh`)
holds the mesh, the param spec tree and the slot axes, and gives the
model code:

* :meth:`~MeshScope.rows` — this rank's slots of a batch (the slots are
  split over 'data' where the batch divides, as the cache's spec says);
* :meth:`~MeshScope.layer` — a layer's weights in the layout the layer
  runs in: gathered over every axis but 'model' (the FSDP all-gather,
  once a layer), and on 'model' column-split (wq, wk, wv, up, gate:
  their output channels), row-split (wo, down: their input channels) or
  whole, by the layer's :class:`Plan`;
* :meth:`~MeshScope.row_linear` — a row-split product: each rank's
  partial fp32 accumulator, summed over 'model' before the epilogue (the
  int8 codes' scale and bias, the fp bias), so an accumulator that is
  exact, as integer inputs times int8 codes are, gives the unsharded
  result bitwise;
* :meth:`~MeshScope.embed` / :meth:`~MeshScope.logits` — the
  vocab-sharded table lookup (each rank looks up the ids it owns; the
  owner's row is picked from the gathered lookups, exact) and the
  logits gathered over 'model' and the slots over 'data', so every rank
  samples the same tokens.

The plan follows the config and the mesh: attention is split over
'model' when the heads divide it (the KV heads too, else every rank
keeps all KV heads and reads the ones its query heads use, as the rules'
GQA refinement replicates wk / wv); the MLP when d_ff does (a MoE's
dense layers' width; its shared experts' width for them); a MoE's
routed expert stacks keep their split over 'model' (the experts this
rank owns, for ``moe.moe_ffn``'s expert parallelism). Leaves are moved
to that layout whatever their spec, so any spec the rules give runs."""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.tree import tree_map
from . import collectives as C
from .sharding import P, spec_axes, spec_entries, tree_map_with_path

TP = "model"
_ctx = threading.local()


def current() -> Optional["MeshScope"]:
    """The installed scope, or None (the unsharded code path)."""
    return getattr(_ctx, "scope", None)


class use_mesh:
    """Install a :class:`MeshScope` for the model code of a step."""

    def __init__(self, scope: Optional["MeshScope"]):
        self.scope = scope

    def __enter__(self):
        self.prev = current()
        _ctx.scope = self.scope
        return self.scope

    def __exit__(self, *exc):
        _ctx.scope = self.prev


@dataclass(frozen=True)
class Plan:
    """How a decoder layer runs on 'model' (size ``m``): attention split
    (heads / m a rank), its KV heads split, the MLP split (d_ff / m; a
    MoE's dense layers' width), a MoE's shared experts split (their
    width / m)."""
    m: int
    attn: bool
    kv: bool
    mlp: bool
    shared: bool = False


def drop_lead(spec, ndim: int, lead: int) -> P:
    """A stacked leaf's spec (``ndim`` dims) without its ``lead`` leading
    (layer) entries: the spec of one layer's slice."""
    return P(*spec_entries(spec, ndim)[lead:])


class MeshScope:
    """See the module docstring. ``dp``: the mesh axes the slots are
    split over (``rules.batch_axes`` of the serving shape), () for
    replicated slots."""

    def __init__(self, mesh, cfg, param_specs, dp: Tuple[str, ...] = ()):
        self.mesh = mesh
        self.specs = param_specs
        self.dp = tuple(dp)
        m = mesh.shape.get(TP, 1)
        attn = cfg.num_heads % m == 0
        moe = cfg.moe
        ff = (moe.first_dense_ff or cfg.d_ff) if moe is not None \
            else cfg.d_ff
        shared = moe.num_shared * moe.d_ff_expert if moe is not None else 0
        self.plan = Plan(m=m, attn=attn,
                         kv=attn and cfg.num_kv_heads % m == 0,
                         mlp=ff % m == 0, shared=shared % m == 0)
        self.rank_m = mesh.coords.get(TP, 0)
        self.cfg = cfg
        self.local_cfg = self.local(cfg)
        self.kv_index = None
        if self.plan.attn and not self.plan.kv and m > 1:
            # every rank keeps all KV heads; local query head i reads the
            # KV head of global head rank_m * H / m + i
            hl = self.local_cfg.num_heads
            rep = cfg.num_heads // cfg.num_kv_heads
            self.kv_index = (self.rank_m * hl + torch.arange(hl)) // rep

    def local(self, cfg):
        """``cfg`` (this scope's, or one that differs from it only in
        fields the plan does not read) with this rank's heads and d_ff."""
        plan, m = self.plan, self.plan.m
        return cfg.replace(
            num_heads=cfg.num_heads // m if plan.attn else cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads // m if plan.kv
            else cfg.num_kv_heads,
            d_ff=cfg.d_ff // m if plan.mlp else cfg.d_ff)

    # -- slots -------------------------------------------------------------

    def _dp_coord(self) -> Tuple[int, int]:
        n, idx = 1, 0
        for a in self.dp:
            idx = idx * self.mesh.shape[a] + self.mesh.coords[a]
            n *= self.mesh.shape[a]
        return idx, n

    def rows(self, b: int) -> slice:
        """This rank's rows of a ``b``-slot batch."""
        idx, n = self._dp_coord()
        per = b // n
        return slice(idx * per, (idx + 1) * per)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows (dim 0), in slot order."""
        return C.all_gather(x, self.mesh, self.dp, 0) if self.dp else x

    # -- weights -----------------------------------------------------------

    def _localize(self, leaf: torch.Tensor, spec, want: Optional[int]
                  ) -> torch.Tensor:
        """``leaf`` (this rank's slice under ``spec``) gathered over every
        axis but 'model', and on 'model' split along dim ``want`` (None:
        whole)."""
        have = None
        for d, part in enumerate(spec_entries(spec, leaf.ndim)):
            axes = [a for a in spec_axes(part) if a in self.mesh.axis_names]
            other = tuple(a for a in axes if a != TP)
            if other:
                if TP in axes:       # a dim over several axes: whole first
                    leaf = C.all_gather(leaf, self.mesh, tuple(axes), d)
                    continue
                leaf = C.all_gather(leaf, self.mesh, other, d)
            elif TP in axes:
                have = d
        if want is not None:
            want = want % leaf.ndim
        if have == want:
            return leaf
        if have is not None:
            leaf = C.all_gather(leaf, self.mesh, TP, have)
        if want is not None and self.plan.m > 1:
            size = leaf.shape[want] // self.plan.m
            leaf = leaf.narrow(want, self.rank_m * size, size)
        return leaf

    def _want(self, path: str, leaf, spec) -> Optional[int]:
        """The 'model' dim a layer leaf runs split along, by the plan:
        columns (the last dim) of wq / wk / wv / up / gate, rows (dim 0)
        of wo / down's weights (a MoE's shared experts' too); a routed
        expert stack as its spec splits it (the experts this rank owns,
        ``moe.moe_ffn``'s expert parallelism); None for the rest."""
        name = path.split("/")
        last = name[-1]
        plan = self.plan
        if name[0] in ("wq", "wk", "wv"):
            split = plan.attn if name[0] == "wq" else plan.kv
            return -1 if split and last in ("w", "qw", "b", "scale") else None
        if name[0] == "wo":
            return 0 if plan.attn and last in ("w", "qw") else None
        if name[0] == "moe":
            if len(name) == 2 and name[1] in ("up", "gate", "down"):
                return self._model_dim(leaf, spec)
            name, split = name[1:], plan.shared
        else:
            split = plan.mlp
        if name[0] in ("mlp", "shared") and len(name) > 2:
            if name[1] in ("up", "gate"):
                return -1 if split and last in ("w", "qw", "b", "scale") \
                    else None
            if name[1] == "down":
                return 0 if split and last in ("w", "qw") else None
        return None

    def layer(self, lp, lspec):
        """A layer's weights in the layout the layer runs in."""
        return tree_map_with_path(
            lambda path, leaf, spec: self._localize(
                leaf, spec, self._want(path, leaf, spec)), lp, lspec)

    def whole(self, tree, spec_tree):
        """A subtree gathered over every axis but 'model', its 'model'
        split kept (the embedding table, the head)."""
        return tree_map(lambda leaf, spec: self._localize(
            leaf, spec, self._model_dim(leaf, spec)), tree, spec_tree)

    def _model_dim(self, leaf, spec) -> Optional[int]:
        for d, part in enumerate(spec_entries(spec, leaf.ndim)):
            if TP in spec_axes(part) and len(spec_axes(part)) == 1:
                return d
        return None

    # -- products ----------------------------------------------------------

    def row_linear(self, p, x: torch.Tensor, split: bool) -> torch.Tensor:
        """A product whose input channels are split over 'model' (when
        ``split``): the partial accumulators summed before the
        epilogue."""
        from repro_torch.models import nn
        if not split or self.plan.m == 1:
            return nn.linear(p, x)
        acc = C.all_reduce(nn.linear_acc(p, x), self.mesh, TP)
        return nn.linear_epilogue(p, acc, x.dtype)

    def embed(self, p, spec, ids: torch.Tensor) -> torch.Tensor:
        """The table lookup of ``ids``; a vocab split over 'model' is
        looked up by the owner of each id."""
        table = self._localize(p["table"], spec["table"],
                               self._model_dim(p["table"], spec["table"]))
        if table.shape[0] == self.cfg.vocab_size:
            return table[ids]
        per = table.shape[0]
        local = ids - self.rank_m * per
        mine = (local >= 0) & (local < per)
        rows = table[local.clamp(0, per - 1)] * mine[..., None].to(table.dtype)
        every = C.all_gather(rows[None], self.mesh, TP, 0)
        owner = torch.div(ids, per, rounding_mode="floor").long()
        return torch.take_along_dim(every, owner[None, ..., None], dim=0)[0]

    def logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Local logits -> the whole vocab (gathered over 'model' when
        split) for every slot (gathered over the slot axes)."""
        if logits.shape[-1] != self.cfg.vocab_size:
            logits = C.all_gather(logits, self.mesh, TP, logits.ndim - 1)
        return self.gather_rows(logits)
