"""The dense decoder-only transformer family: nemotron-4-15b (full
attention, squared ReLU), gemma3-12b (5:1 local:global, qk-norm, GeGLU,
tied embeddings), h2o-danube-3-4b (sliding window), granite-20b (MQA),
and spikingformer-lm, the family in spiking mode (LIF activations over
T_s steps, binary attention), with full, sliding-window or local/global
attention.

Mirrors ``repro.models.transformer``: ``init`` in the JAX tree layout
(per-layer leaves stacked on a leading axis, ``local_global``'s on two:
(groups, global_every)), ``forward`` (train / prefill), and the decode
path: ``init_cache``, ``decode_step`` (one token or a chunked-prefill
bite per slot, per-slot positions and validity tags) and
``invalidate_slots``.

* A spiking full-attention layer is the engine's ``layer_step_causal``
  (the layer program's kernels on the card). Every other layer is plain
  PyTorch, as it is jnp in JAX: the chunked online-softmax
  ``flash_attention`` (full), ``banded_flash_attention`` (window), and in
  spiking mode ``binary_flash_attention`` with the window mask.
* Window layers decode against rings of ``min(window + headroom,
  max_len)`` entries (:func:`_cache_len`). The spiking cache holds spike
  K/V bit-packed (32 channels a 32-bit word, kept as int32 words with the
  uint32 bit pattern) and T*B rows, scored with AND-popcount; the dense
  one holds K/V in the activation dtype and B rows.

The decode path updates the cache in place (JAX returns a new one) and
returns it, so a server holds one cache and copies none of it a wave.
Under a mesh (``parallel.spmd.use_mesh``, installed by the server) the
decode step runs on this rank's slots, heads and d_ff columns: the
vocab-sharded lookup, each layer's weights gathered over 'data' once, wo
and down summed over 'model' before their epilogues, the logits gathered
over 'model' and the slots over 'data'.
"""
from __future__ import annotations

import math
from itertools import product
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitpack import pack_bits, popcount_matmul, unpack_bits
from repro_torch.core.engine import layer_step_causal
from repro_torch.core.spiking import binarize, lif_scan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel import spmd
from repro_torch.tree import tree_map
from . import nn


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    p = {
        "ln1": nn.rmsnorm_init(cfg.d_model, dt),
        "wq": nn.linear_init(gen, cfg.d_model, cfg.q_dim, dtype=dt),
        "wk": nn.linear_init(gen, cfg.d_model, cfg.kv_dim, dtype=dt),
        "wv": nn.linear_init(gen, cfg.d_model, cfg.kv_dim, dtype=dt),
        "wo": nn.linear_init(
            gen, cfg.q_dim, cfg.d_model,
            std=1.0 / math.sqrt(cfg.q_dim * 2 * cfg.num_layers), dtype=dt),
        "ln2": nn.rmsnorm_init(cfg.d_model, dt),
        "mlp": nn.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated,
                           dtype=dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = nn.rmsnorm_init(cfg.head_dim, dt)
        p["k_norm"] = nn.rmsnorm_init(cfg.head_dim, dt)
    if cfg.spiking is not None:
        p["delta"] = torch.tensor(cfg.spiking.attn_threshold_init,
                                  dtype=torch.float32)
    return p


def _stacked_layers(gen: torch.Generator, cfg: ModelConfig,
                    lead: Tuple[int, ...], dev: torch.device,
                    layer_init=_layer_init):
    """Layer trees of ``layer_init`` stacked on the leading axes ``lead``,
    drawn one layer at a time into preallocated leaves (a whole model's
    layers never exist twice)."""
    out = None
    for idx in product(*(range(n) for n in lead)):
        layer = layer_init(gen, cfg)
        if out is None:
            out = tree_map(lambda a: torch.empty(
                (*lead, *a.shape), dtype=a.dtype, device=dev), layer)
        tree_map(lambda o, a: o[idx].copy_(a), out, layer)
    return out


def init(cfg: ModelConfig, seed: int = 0, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    """Params in the JAX layout from a ``torch.Generator`` on ``device``
    (the GPU by default) seeded with ``seed`` (not JAX's numbers: tests
    convert JAX's params instead). Each leaf is drawn where it lives."""
    dev = resolve_device(device)
    gen = nn.generator(dev).manual_seed(seed)
    dt = dtype_of(cfg)
    params: Dict[str, Any] = {
        "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": nn.rmsnorm_init(cfg.d_model, dt),
    }
    if cfg.attn_type == "local_global":
        lead = (cfg.num_layers // cfg.global_every, cfg.global_every)
        params["groups"] = _stacked_layers(gen, cfg, lead, dev)
    else:
        params["layers"] = _stacked_layers(gen, cfg, (cfg.num_layers,), dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                           dtype=dt)
    return tree_map(lambda a: a.to(dev), params)


def _layer(params, i: int):
    return tree_map(lambda a: a[i], params["layers"])


def _layer_specs(params, specs, cfg: ModelConfig) -> Iterator[Any]:
    """One layer's spec tree at a time, in :func:`_layers`' order (the
    stacked leaves' specs without their leading layer entries)."""
    key, lead = ("groups", 2) if cfg.attn_type == "local_global" \
        else ("layers", 1)
    one = tree_map(lambda a, s: spmd.drop_lead(s, a.ndim, lead),
                   params[key], specs[key])
    for _ in range(cfg.num_layers):
        yield one


def _row(p, x: torch.Tensor, part: str) -> torch.Tensor:
    """A product whose input channels a mesh may split over 'model' (wo:
    ``part`` 'attn', down: 'mlp'): summed over the ranks before its
    epilogue; without a mesh :func:`nn.linear`."""
    scope = spmd.current()
    if scope is None:
        return nn.linear(p, x)
    return scope.row_linear(p, x, getattr(scope.plan, part))


def _mlp(p, x: torch.Tensor, act: str, part: str = "mlp") -> torch.Tensor:
    """:func:`nn.mlp` with its down product through :func:`_row` (``part``
    'mlp', or a MoE's 'shared' experts)."""
    if spmd.current() is None:
        return nn.mlp(p, x, act)
    h = nn.linear(p["up"], x)
    if "gate" in p:
        h = nn.activation(act)(nn.linear(p["gate"], x)) * h
    else:
        h = nn.activation(act)(h)
    return _row(p["down"], h, part)


def _layers(params, cfg: ModelConfig) -> Iterator[Tuple[str, Any]]:
    """(kind, layer params) in execution order: ``local_global`` runs
    each group's ``global_every - 1`` window layers, then its full one."""
    if cfg.attn_type == "local_global":
        g, every = cfg.num_layers // cfg.global_every, cfg.global_every
        for gi, j in product(range(g), range(every)):
            yield ("full" if j == every - 1 else "window",
                   tree_map(lambda a: a[gi, j], params["groups"]))
        return
    kind = "window" if cfg.attn_type == "swa" else "full"
    for i in range(cfg.num_layers):
        yield kind, _layer(params, i)


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------


def _project_qkv(p, cfg: ModelConfig, h: torch.Tensor, positions,
                 repeat_kv: bool = False):
    """h: (..., S, D) -> q (..., S, H, hd), k / v (..., S, KH, hd), q and k
    (qk-normed and) roped; ``repeat_kv`` repeats the KV heads up to H."""
    lead, s = h.shape[:-2], h.shape[-2]
    q = nn.linear(p["wq"], h).reshape(*lead, s, cfg.num_heads, cfg.head_dim)
    k = nn.linear(p["wk"], h).reshape(*lead, s, cfg.num_kv_heads,
                                      cfg.head_dim)
    v = nn.linear(p["wv"], h).reshape(*lead, s, cfg.num_kv_heads,
                                      cfg.head_dim)
    if cfg.qk_norm:
        q = nn.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = nn.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = nn.rope(q.reshape(-1, s, cfg.num_heads, cfg.head_dim), positions,
                cfg.rope_theta).reshape(q.shape)
    k = nn.rope(k.reshape(-1, s, cfg.num_kv_heads, cfg.head_dim), positions,
                cfg.rope_theta).reshape(k.shape)
    if repeat_kv and cfg.num_heads != cfg.num_kv_heads:
        rep = cfg.num_heads // cfg.num_kv_heads
        k = k.repeat_interleave(rep, dim=-2)
        v = v.repeat_interleave(rep, dim=-2)
    return q, k, v


def _attend_full_seq(cfg: ModelConfig, kind: str, q, k, v, delta=None):
    """kind: 'full' | 'window'; q, k, v: (B', S, H, hd), KV heads
    repeated."""
    window = cfg.window if kind == "window" else None
    if cfg.spiking is not None:
        if window is None:
            # the binary engine's dispatch, on (B', H, S, hd)
            from repro_torch.core.attention import spiking_attention
            swap = lambda u: u.transpose(1, 2)
            return swap(spiking_attention(swap(q), swap(k), swap(v),
                                          cfg.spiking, delta_score=delta,
                                          causal=True))
        return nn.binary_flash_attention(
            q, k, v, delta=delta, alpha=cfg.spiking.surrogate_alpha,
            causal=True, window=window,
            binarize_scores=cfg.spiking.binarize_scores)
    if window is not None:
        return nn.banded_flash_attention(q, k, v, window=window)
    return nn.flash_attention(q, k, v, causal=True)


def _spike(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """LIF over the leading time axis: (T, ...) currents -> spikes."""
    return lif_scan(x, cfg.spiking)[0]


def apply_layer(p, cfg: ModelConfig, x: torch.Tensor, positions, kind: str,
                train: bool) -> torch.Tensor:
    """x: (B, S, D), or (T, B, S, D) in spiking mode. A spiking
    full-attention layer is the engine's layer program
    (``layer_step_causal``); the rest is the reference's dataflow."""
    spiking = cfg.spiking is not None
    if spiking and kind == "full":
        return layer_step_causal(p, cfg, x, positions, train=train)
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, h, positions, repeat_kv=True)
    if spiking:
        fold = lambda u: _spike(u, cfg).reshape(-1, *u.shape[2:])
        attn = _attend_full_seq(cfg, kind, fold(q), fold(k), fold(v),
                                delta=p["delta"])
    else:
        attn = _attend_full_seq(cfg, kind, q, k, v)
    x = x + nn.linear(p["wo"], attn.reshape(*x.shape[:-1], cfg.q_dim))
    h2 = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if spiking:
        up = nn.linear(p["mlp"]["up"], h2)
        return x + nn.linear(p["mlp"]["down"], _spike(up, cfg))
    return x + nn.mlp(p["mlp"], h2, cfg.act)


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return nn.unembed(params["embed"], x)
    return nn.linear(params["lm_head"], x).float()


def forward(params, cfg: ModelConfig, batch, *, train: bool = False,
            inputs_embeds: Optional[torch.Tensor] = None):
    """batch: {'tokens': (B, S)} (``inputs_embeds`` (B, S, D) in place of
    the lookup: the vlm family's patches and text); returns (logits (B, S,
    V) fp32, {})."""
    x = nn.embed(params["embed"], batch["tokens"]) if inputs_embeds is None \
        else inputs_embeds
    positions = torch.arange(x.shape[-2], device=x.device)
    if cfg.spiking is not None:
        x = x[None].expand(cfg.spiking.time_steps, *x.shape)
    for kind, lp in _layers(params, cfg):
        x = apply_layer(lp, cfg, x, positions, kind, train)
    if cfg.spiking is not None:
        x = x.mean(dim=0)               # rate decoding over T_s
    return _head(params, cfg, x), {}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _cache_len(cfg: ModelConfig, kind: str, max_len: int,
               headroom: int = 0) -> int:
    """Ring length of a cache of this kind. A window ring gets up to
    ``headroom`` (chunk - 1) extra entries: a C-token bite is written
    before it attends, and on a bare window-long ring its later writes
    would evict entries still inside its earlier queries' windows."""
    if kind != "window":
        return max_len
    return min(cfg.window + headroom, max_len)


def _packed_kv(cfg: ModelConfig) -> bool:
    """The config's engine asks for the bit-packed spike KV cache."""
    return (cfg.spiking is not None and cfg.engine is not None
            and cfg.engine.packed_kv)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, batch=None,
               params=None, chunk_headroom: int = 0, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """{'layers': ...}, or {'local': ..., 'global': ...} for
    ``local_global`` (its window layers, group by group, then one full
    layer a group), each {'k', 'v': (n_layers, rows, s, KH, words) int32
    words (packed spikes) or (..., hd) in the activation dtype, 'pos':
    (n_layers, B, s) int32 validity tags, -1 = empty}, on ``device``.
    rows = T*B in spiking mode, B otherwise; s = :func:`_cache_len`
    (``chunk_headroom``: pass the widest chunked-prefill bite - 1)."""
    dev = resolve_device(device)
    rows = batch_size * (cfg.spiking.time_steps if cfg.spiking else 1)
    packed = _packed_kv(cfg)
    tail = -(-cfg.head_dim // 32) if packed else cfg.head_dim
    kv_dtype = torch.int32 if packed else dtype_of(cfg)

    def kv(n_layers, kind):
        s = _cache_len(cfg, kind, max_len, chunk_headroom)
        shape = (n_layers, rows, s, cfg.num_kv_heads, tail)
        return {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
                "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
                "pos": torch.full((n_layers, batch_size, s), -1,
                                  dtype=torch.int32, device=dev)}

    if cfg.attn_type == "local_global":
        g = cfg.num_layers // cfg.global_every
        return {"local": kv(g * (cfg.global_every - 1), "window"),
                "global": kv(g, "full")}
    return {"layers": kv(cfg.num_layers,
                         "window" if cfg.attn_type == "swa" else "full")}


def _cache_layers(cfg: ModelConfig, cache) -> Iterator[Dict[str, Any]]:
    """Each layer's cache views in :func:`_layers`' order: group g's
    window layer j reads local entry g * (global_every - 1) + j, its full
    layer global entry g."""
    def view(group, i):
        return {key: leaf[i] for key, leaf in group.items()}
    if cfg.attn_type == "local_global":
        n_local = cfg.global_every - 1
        for gi in range(cfg.num_layers // cfg.global_every):
            for j in range(n_local):
                yield view(cache["local"], gi * n_local + j)
            yield view(cache["global"], gi)
        return
    for i in range(cfg.num_layers):
        yield view(cache["layers"], i)


def _scatter_rows(cache: torch.Tensor, new: torch.Tensor,
                  slots: torch.Tensor) -> torch.Tensor:
    """In place: row b writes new[b, i] at cache[b, slots[b, i]]; slot
    indices >= S (the padding sentinel) are dropped."""
    keep = slots < cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None
                                                             ].expand_as(slots)
    cache[rows[keep], slots[keep]] = new[keep].to(cache.dtype)
    return cache


def _decode_layer(p, cfg: ModelConfig, x: torch.Tensor, cache_l, pos,
                  n_tok, kind: str):
    """One decode token or a chunked-prefill bite against this layer's
    cache (updated in place). x: (B', C, D), B' = T*B (spiking,
    time-major) or B; pos: (B,) position of x[:, 0] per slot; n_tok: (B,)
    real tokens per slot (the rest of the row is padding, neither
    written nor tagged); kind: 'full' | 'window'."""
    b = pos.shape[0]
    b_rows, c = x.shape[0], x.shape[1]
    reps_t = b_rows // b                 # T_s in spiking mode, else 1
    tile = (lambda u: u.repeat(reps_t, *([1] * (u.ndim - 1)))) \
        if reps_t > 1 else (lambda u: u)
    qpos = pos[:, None] + torch.arange(c, device=x.device)       # (B, C)
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, h, tile(qpos))
    spiking = cfg.spiking is not None
    if spiking:
        t = cfg.spiking.time_steps

        def lif_t(u):      # T is folded into rows, time-major
            return lif_scan(u.reshape(t, -1, *u.shape[1:]), cfg.spiking
                            )[0].reshape(u.shape)
        q, k, v = lif_t(q), lif_t(k), lif_t(v)
    window = cfg.window if kind == "window" else None
    packed = _packed_kv(cfg)
    if packed:
        k, v = pack_bits(k), pack_bits(v)
    s_len = cache_l["k"].shape[1]
    # ring write (== the position for full caches); padding -> s_len
    slot = torch.where(torch.arange(c, device=x.device)[None, :]
                       < n_tok[:, None], qpos % s_len,
                       torch.full_like(qpos, s_len))
    k_cache = _scatter_rows(cache_l["k"], k, tile(slot))
    v_cache = _scatter_rows(cache_l["v"], v, tile(slot))
    entry_pos = _scatter_rows(cache_l["pos"], qpos.to(torch.int32), slot)
    scope = spmd.current()
    if scope is not None and scope.kv_index is not None:
        # all KV heads cached, this rank's query heads read their own
        idx = scope.kv_index.to(x.device)
        k_cache, v_cache = k_cache.index_select(2, idx), \
            v_cache.index_select(2, idx)
    if spiking:
        kh = k_cache.shape[2]
        rep = cfg.num_heads // kh
        qf = q.reshape(b_rows, c, kh, rep, cfg.head_dim)
        if packed:
            # AND-popcount against the packed cache: exact integer counts
            qp = pack_bits(qf).permute(0, 2, 1, 3, 4).reshape(
                b_rows, kh, c * rep, -1)                 # (B', KH, C*rep, W)
            counts = popcount_matmul(qp, k_cache.transpose(1, 2))
            counts = counts.reshape(b_rows, kh, c, rep, s_len
                                    ).permute(0, 2, 1, 3, 4)
            sc = counts.float() / math.sqrt(cfg.head_dim)
        else:
            sc = torch.einsum("bcgrd,bkgd->bcgrk", qf.float(),
                              k_cache.float()) / math.sqrt(cfg.head_dim)
        a = binarize(sc, p["delta"], cfg.spiking.surrogate_alpha)
        e = entry_pos[:, None, :]
        valid = (e >= 0) & (e <= qpos[:, :, None])                # (B, C, S)
        if window is not None:
            valid = valid & (e > qpos[:, :, None] - window)
        a = torch.where(tile(valid)[:, :, None, None, :], a, 0.0)
        vc = unpack_bits(v_cache, cfg.head_dim) if packed \
            else v_cache.float()
        attn = torch.einsum("bcgrk,bkgd->bcgrd", a, vc).to(x.dtype)
    else:
        attn = nn.decode_attention(q, k_cache, v_cache, entry_pos=entry_pos,
                                   cur_pos=qpos, window=window)
    x = x + _row(p["wo"], attn.reshape(b_rows, c, cfg.q_dim), "attn")
    h2 = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if spiking:
        up = nn.linear(p["mlp"]["up"], h2)
        return x + _row(p["mlp"]["down"], lif_t(up), "mlp")
    return x + _mlp(p["mlp"], h2, cfg.act)


def _head_sharded(params, cfg: ModelConfig, x: torch.Tensor,
                  scope) -> torch.Tensor:
    """:func:`_head` on a rank: the head's vocab columns it holds, the
    logits gathered over 'model' and the slots over 'data'."""
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        table = scope.whole(params["embed"], scope.specs["embed"])["table"]
        logits = nn.unembed({"table": table}, x)
    else:
        head = scope.whole(params["lm_head"], scope.specs["lm_head"])
        logits = nn.linear(head, x).float()
    return scope.logits(logits)


def decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                n_tok: Optional[torch.Tensor] = None):
    """tokens: (B, C) int — one decode token per slot (C == 1) or a
    chunked-prefill bite; pos: scalar or (B,), the position of
    tokens[:, 0] per slot; n_tok: optional (B,) real tokens per row.
    Returns (logits (B, C, V) fp32, cache), the cache updated in place."""
    dev = params["embed"]["table"].device
    tokens = torch.as_tensor(tokens, device=dev)
    b, c = tokens.shape
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    if pos.ndim == 0:
        pos = pos.expand(b)
    n_tok = torch.full((b,), c, dtype=torch.int64, device=dev) \
        if n_tok is None else torch.as_tensor(n_tok, device=dev).long()
    scope = spmd.current()
    if scope is not None:
        # this rank's slots; its cache holds only them
        rows = scope.rows(b)
        tokens, pos, n_tok = tokens[rows], pos[rows], n_tok[rows]
        x = scope.embed(params["embed"], scope.specs["embed"], tokens)
        lcfg = scope.local_cfg
        specs = _layer_specs(params, scope.specs, cfg)
    else:
        x = nn.embed(params["embed"], tokens)
        lcfg, specs = cfg, None
    if cfg.spiking is not None:
        t = cfg.spiking.time_steps
        x = x[None].expand(t, *x.shape).reshape(-1, *x.shape[1:])
    for (kind, lp), cache_l in zip(_layers(params, cfg),
                                   _cache_layers(cfg, cache)):
        if scope is not None:
            lp = scope.layer(lp, next(specs))
        x = _decode_layer(lp, lcfg, x, cache_l, pos, n_tok, kind)
    if cfg.spiking is not None:
        x = x.reshape(t, -1, *x.shape[1:]).mean(dim=0)
    if scope is not None:
        return _head_sharded(params, cfg, x, scope), cache
    return _head(params, cfg, x), cache


def invalidate_slots(cache, slot_mask: torch.Tensor):
    """Free masked slots for re-admission (in place): every validity tag
    of a masked slot goes to -1; the K/V payloads stay (tags alone gate
    attention). slot_mask: (B,) bool."""
    for group in cache.values():
        pos = group["pos"]
        pos.masked_fill_(torch.as_tensor(slot_mask, device=pos.device)
                         [None, :, None], -1)
    return cache
