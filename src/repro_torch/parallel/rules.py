"""Per-family parameter / cache / batch sharding rules (the tables of
``repro.parallel.rules``, verbatim).

Production meshes: (data=16, model=16) and (pod=2, data=16, model=16).
Scheme: batch over ('pod', 'data'); FSDP over 'data' (a rank gathers a
layer's weights over 'data' before it runs the layer); TP over 'model'
(attention q / o and d_ff columns, vocab, experts, mamba d_inner, rwkv
channels). Dims that don't divide fall back to replicated
(``sharding.fit_spec_to_shape``): hymba's 25 heads, whisper's odd vocab.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from repro_torch.configs.base import ModelConfig, RunShape
from .sharding import (P, fit_spec_to_shape, param_specs,
                       tree_map_with_path)

BATCH = ("pod", "data")
FSDP = "data"
TP = "model"

_DENSE = [
    (r"embed/table", P(TP, FSDP)),
    (r"lm_head/w", P(FSDP, TP)),
    (r"mm_projector/.*w", P(FSDP, TP)),
    (r"(wq|wk|wv)/(w|b)", P(FSDP, TP)),
    (r"wo/w", P(TP, FSDP)),
    (r"mlp/(up|gate)/(w|b)", P(FSDP, TP)),
    (r"mlp/down/w", P(TP, FSDP)),
    (r"(self_attn|cross_attn|attn)/(wq|wk|wv)/(w|b)", P(FSDP, TP)),
    (r"(self_attn|cross_attn|attn)/wo/w", P(TP, FSDP)),
    (r"pos_embed", P(None, FSDP)),
    # quantized linears: int8 / packed-int4 codes shard like their fp
    # weights (int4 halves the K rows: a non-dividing K falls back per
    # dimension); per-output-channel scales shard with N
    (r"(wq|wk|wv)/qw", P(FSDP, TP)),
    (r"wo/qw", P(TP, FSDP)),
    (r"mlp/(up|gate)/qw", P(FSDP, TP)),
    (r"mlp/down/qw", P(TP, FSDP)),
    (r"lm_head/qw", P(FSDP, TP)),
    (r"(wq|wk|wv|up|gate|lm_head)/scale", P(TP)),
    (r"(wo|down)/scale", P(FSDP)),
]

_MOE = [
    (r"moe/router", P()),
    (r"moe/(up|gate)", P(TP, FSDP, None)),
    (r"moe/down", P(TP, None, FSDP)),
    (r"moe/shared/(up|gate)/w", P(FSDP, TP)),
    (r"moe/shared/down/w", P(TP, FSDP)),
] + _DENSE

_RWKV = [
    # gates (wg, cm.wr) multiply replicated values elementwise: keep them
    # replicated
    (r"tm/wg/w", P(FSDP, None)),
    (r"cm/wr/w", P(FSDP, None)),
    (r"tm/(wr|wk|wv)/w", P(FSDP, TP)),
    (r"tm/wo/w", P(TP, FSDP)),
    (r"cm/wk/w", P(FSDP, TP)),
    (r"cm/wv/w", P(TP, FSDP)),
    (r"embed/table", P(TP, FSDP)),
    (r"lm_head/w", P(FSDP, TP)),
]

_HYBRID = [
    (r"mamba/in_proj/w", P(FSDP, TP)),
    (r"mamba/conv_w", P(None, TP)),
    (r"mamba/conv_b", P(TP)),
    (r"mamba/x_proj/w", P(TP, None)),
    (r"mamba/dt_proj/(w|b)", P(None, TP)),
    (r"mamba/A_log", P(TP, None)),
    (r"mamba/D", P(TP)),
    (r"mamba/out_proj/w", P(TP, FSDP)),
] + _DENSE

FAMILY_RULES: Dict[str, List[Tuple[str, P]]] = {
    "dense": _DENSE,
    "vlm": _DENSE,
    "encdec": _DENSE,
    "moe": _MOE,
    "rwkv": _RWKV,
    "hybrid": _HYBRID,
    "spikingformer": [],
    "cifarnet": [],
}


def _strip_fsdp(spec: P) -> P:
    parts = []
    for part in spec:
        if part == FSDP:
            parts.append(None)
        elif isinstance(part, tuple):
            kept = tuple(a for a in part if a != FSDP)
            parts.append(kept if len(kept) > 1 else
                         (kept[0] if kept else None))
        else:
            parts.append(part)
    return P(*parts)


def rules_for(cfg: ModelConfig, mesh=None,
              scheme: str = "fsdp") -> List[Tuple[str, P]]:
    """Param-sharding rules for a family under a scheme.

    scheme='fsdp'  — weights sharded over ('data', 'model'): least memory,
                     a gather over 'data' a layer (ZeRO-3-like).
    scheme='zero1' — weights resident (TP over 'model' only); optimizer
                     states stay FSDP-sharded.

    Refinement (both schemes): when the KV heads can't shard over the
    model axis, wk / wv outputs are replicated instead of column-sharded
    (a column split would cut a head in two)."""
    rules = list(FAMILY_RULES[cfg.family])
    model_size = mesh.shape.get(TP, 1) if mesh is not None else 16
    if cfg.family in ("dense", "moe", "vlm", "hybrid") and \
            cfg.num_kv_heads % model_size != 0:
        rules = [(r"(wk|wv)/(w|b)", P(FSDP, None)),
                 (r"(wk|wv)/qw", P(FSDP, None)),
                 (r"(wk|wv)/scale", P())] + rules
    if scheme == "zero1":
        rules = [(rx, _strip_fsdp(spec)) for rx, spec in rules]
    return rules


def params_partition(cfg: ModelConfig, abstract_params, mesh,
                     scheme: str = "fsdp"):
    """Spec tree for a (possibly abstract: meta) param tree."""
    return param_specs(abstract_params, rules_for(cfg, mesh, scheme),
                       default=P(), mesh=mesh)


def batch_axes(shape: RunShape, mesh) -> Tuple[str, ...]:
    """DP axes for this run shape; decode batch=1 stays replicated."""
    axes, prod = [], 1
    for a in BATCH:
        if a in mesh.axis_names:
            n = mesh.shape[a]
            if shape.global_batch % (prod * n) == 0:
                axes.append(a)
                prod *= n
    return tuple(axes)


def dp_part(dp: Tuple[str, ...]):
    """A DP-axis tuple as a spec entry: () -> None, one axis -> its name,
    several -> the tuple."""
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def batch_partition(cfg: ModelConfig, shape: RunShape, mesh,
                    batch_tree) -> Any:
    """Spec tree for a data batch (tokens / embeds / labels / images)."""
    dp = dp_part(batch_axes(shape, mesh))

    def assign(path, leaf):
        nd = len(leaf.shape)
        return P(*((dp,) + (None,) * (nd - 1))) if nd else P()

    return tree_map_with_path(assign, batch_tree)


_CACHE_RULES_BASE = [
    (r"(^|/)(k|v)$", P(None, BATCH, "__SEQ__", TP, None)),
    (r"cross_(k|v)$", P(None, BATCH, None, TP, None)),
    (r"(^|/)pos$", P()),
    (r"wkv$", P(None, BATCH, None, None, None)),
    (r"tm_prev$", P(None, BATCH, None)),
    (r"cm_prev$", P(None, BATCH, None)),
    (r"ssm$", P(None, BATCH, TP, None)),
    (r"conv$", P(None, BATCH, None, TP)),
]


def cache_partition(cfg: ModelConfig, shape: RunShape, mesh,
                    abstract_cache) -> Any:
    """Spec tree for the decode cache. For long-context decode (a batch
    too small to shard) the KV sequence dim is sharded over 'data'
    instead: sequence-parallel KV."""
    dp = batch_axes(shape, mesh)
    seq_shard = None
    if shape.global_batch < mesh.shape.get("data", 1):
        seq_shard = FSDP

    def materialize(spec: P) -> P:
        parts = []
        for part in spec:
            if part == "__SEQ__":
                parts.append(seq_shard)
            elif part == BATCH:
                parts.append(dp_part(dp))
            else:
                parts.append(part)
        return P(*parts)

    rules = [(rx, materialize(spec)) for rx, spec in _CACHE_RULES_BASE]
    specs = param_specs(abstract_cache, rules, default=P(), mesh=mesh)

    # slotted-decode validity tags are (n_layers, B, s): the slot dim
    # shards with the batch like k / v. Shape-gated (not a regex rule):
    # the other families' tags are 2-d (n_layers, s), where a
    # right-aligned spec would land the batch axes on n_layers.
    def fix_pos(path, leaf, spec):
        if path.rsplit("/", 1)[-1] == "pos" and len(leaf.shape) == 3:
            return fit_spec_to_shape(P(None, dp_part(dp), None),
                                     tuple(leaf.shape), mesh)
        return spec

    return tree_map_with_path(fix_pos, abstract_cache, specs)
