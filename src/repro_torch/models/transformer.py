"""The dense decoder-only transformer family in spiking mode — the
spikingformer-lm serve path.

Mirrors ``repro.models.transformer`` for the spiking full-attention
branch: ``init`` in the JAX tree layout (per-layer leaves stacked on a
leading axis), ``forward`` (train / prefill: every layer is the engine's
``layer_step_causal``), and the decode path: ``init_cache`` (the
bit-packed spike KV cache, 32 spike channels a 32-bit word, kept as int32
words with the uint32 bit pattern), ``decode_step`` (one token or a
chunked-prefill bite per slot, per-slot positions and validity tags,
AND-popcount scoring against the packed cache) and ``invalidate_slots``.
The decode path is plain PyTorch, as it is jnp in JAX. It updates the
cache in place (JAX returns a new one) and returns it, so a server holds
one cache of ``max_len`` slots per layer and copies none of it a wave.

Sliding-window and local/global attention and the non-spiking dense
models are not ported and raise ``NotImplementedError`` (ROADMAP queue 1
item 10).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitpack import pack_bits, popcount_matmul, unpack_bits
from repro_torch.core.engine import layer_step_causal
from repro_torch.core.spiking import binarize, lif_scan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map
from . import nn


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.spiking is None or cfg.attn_type != "full":
        raise NotImplementedError(
            f"{cfg.name}: only the spiking full-attention dense family is "
            f"ported to PyTorch (attn_type={cfg.attn_type!r}, spiking="
            f"{cfg.spiking is not None}; ROADMAP queue 1 item 10)")


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
    p["delta"] = torch.tensor(cfg.spiking.attn_threshold_init,
                              dtype=torch.float32)
    return p


def init(cfg: ModelConfig, seed: int = 0, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    """Params in the JAX layout from a ``torch.Generator`` seeded with
    ``seed`` (not JAX's numbers: tests convert JAX's params instead), on
    ``device`` (the GPU by default)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dt = dtype_of(cfg)
    params: Dict[str, Any] = {
        "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": nn.rmsnorm_init(cfg.d_model, dt),
    }
    layers = [_layer_init(gen, cfg) for _ in range(cfg.num_layers)]
    params["layers"] = tree_map(lambda *a: torch.stack(a), *layers)
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                           dtype=dt)
    return tree_map(lambda a: a.to(dev), params)


def _layer(params, i: int):
    return tree_map(lambda a: a[i], params["layers"])


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------


def _project_qkv(p, cfg: ModelConfig, h: torch.Tensor, positions,
                 repeat_kv: bool = False):
    """h: (..., S, D) -> q (..., S, H, hd), k / v (..., S, KH, hd), q and k
    roped; ``repeat_kv`` repeats the KV heads up to H."""
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


def apply_layer(p, cfg: ModelConfig, x: torch.Tensor, positions, kind: str,
                train: bool) -> torch.Tensor:
    """x: (T, B, S, D). The spiking full-attention layer is the engine's
    layer program (``layer_step_causal``)."""
    if kind != "full":
        raise NotImplementedError(f"{kind!r} attention layers are not "
                                  f"ported to PyTorch yet (ROADMAP queue 1 "
                                  f"item 10)")
    return layer_step_causal(p, cfg, x, positions, train=train)


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return nn.unembed(params["embed"], x)
    return nn.linear(params["lm_head"], x).float()


def forward(params, cfg: ModelConfig, batch, *, train: bool = False):
    """batch: {'tokens': (B, S)}; returns (logits (B, S, V) fp32, {})."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    x = nn.embed(params["embed"], tokens)
    s = x.shape[-2]
    positions = torch.arange(s, device=x.device)
    x = x[None].expand(cfg.spiking.time_steps, *x.shape)
    for i in range(cfg.num_layers):
        x = apply_layer(_layer(params, i), cfg, x, positions, "full", train)
    return _head(params, cfg, x.mean(dim=0)), {}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _packed_kv(cfg: ModelConfig) -> bool:
    """The config's engine asks for the bit-packed spike KV cache."""
    return (cfg.spiking is not None and cfg.engine is not None
            and cfg.engine.packed_kv)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, batch=None,
               params=None, chunk_headroom: int = 0, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """{'layers': {'k', 'v': (n_layers, T*B, max_len, KH, words) int32
    words (packed) or (..., hd) activations, 'pos': (n_layers, B,
    max_len) int32 validity tags, -1 = empty}} on ``device``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    rows = batch_size * cfg.spiking.time_steps
    if _packed_kv(cfg):
        shape = (cfg.num_layers, rows, max_len, cfg.num_kv_heads,
                 -(-cfg.head_dim // 32))
        kv_dtype = torch.int32
    else:
        shape = (cfg.num_layers, rows, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        kv_dtype = dtype_of(cfg)
    return {"layers": {
        "k": torch.zeros(shape, dtype=kv_dtype, device=dev),
        "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
        "pos": torch.full((cfg.num_layers, batch_size, max_len), -1,
                          dtype=torch.int32, device=dev)}}


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
                  n_tok):
    """One decode token or a chunked-prefill bite against this layer's
    cache (updated in place). x: (T*B, C, D); pos: (B,) position of
    x[:, 0] per slot; n_tok: (B,) real tokens per slot (the rest of the
    row is padding, neither written nor tagged)."""
    b = pos.shape[0]
    b_rows, c = x.shape[0], x.shape[1]
    t = cfg.spiking.time_steps
    tile = lambda u: u.repeat(t, *([1] * (u.ndim - 1)))
    qpos = pos[:, None] + torch.arange(c, device=x.device)       # (B, C)
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, h, tile(qpos))

    def lif_t(u):          # T is folded into rows, time-major
        return lif_scan(u.reshape(t, -1, *u.shape[1:]), cfg.spiking
                        )[0].reshape(u.shape)
    q, k, v = lif_t(q), lif_t(k), lif_t(v)
    packed = _packed_kv(cfg)
    if packed:
        k, v = pack_bits(k), pack_bits(v)
    s_len = cache_l["k"].shape[1]
    slot = torch.where(torch.arange(c, device=x.device)[None, :]
                       < n_tok[:, None], qpos % s_len,
                       torch.full_like(qpos, s_len))
    k_cache = _scatter_rows(cache_l["k"], k, tile(slot))
    v_cache = _scatter_rows(cache_l["v"], v, tile(slot))
    entry_pos = _scatter_rows(cache_l["pos"], qpos.to(torch.int32), slot)
    kh, rep = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    qf = q.reshape(b_rows, c, kh, rep, cfg.head_dim)
    if packed:
        # AND-popcount against the packed cache: exact integer counts
        qp = pack_bits(qf).permute(0, 2, 1, 3, 4).reshape(
            b_rows, kh, c * rep, -1)                     # (B', KH, C*rep, W)
        counts = popcount_matmul(qp, k_cache.transpose(1, 2))
        counts = counts.reshape(b_rows, kh, c, rep, s_len
                                ).permute(0, 2, 1, 3, 4)  # (B', C, KH, rep, S)
        sc = counts.float() / math.sqrt(cfg.head_dim)
    else:
        sc = torch.einsum("bcgrd,bkgd->bcgrk", qf.float(),
                          k_cache.float()) / math.sqrt(cfg.head_dim)
    a = binarize(sc, p["delta"], cfg.spiking.surrogate_alpha)
    valid = ((entry_pos[:, None, :] >= 0)
             & (entry_pos[:, None, :] <= qpos[:, :, None]))  # (B, C, S)
    a = torch.where(tile(valid)[:, :, None, None, :], a, 0.0)
    vc = unpack_bits(v_cache, cfg.head_dim) if packed else v_cache.float()
    attn = torch.einsum("bcgrk,bkgd->bcgrd", a, vc)
    attn = attn.reshape(b_rows, c, cfg.q_dim).to(x.dtype)
    x = x + nn.linear(p["wo"], attn)
    h2 = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
    up = nn.linear(p["mlp"]["up"], h2)
    return x + nn.linear(p["mlp"]["down"], lif_t(up))


def decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                n_tok: Optional[torch.Tensor] = None):
    """tokens: (B, C) int — one decode token per slot (C == 1) or a
    chunked-prefill bite; pos: scalar or (B,), the position of
    tokens[:, 0] per slot; n_tok: optional (B,) real tokens per row.
    Returns (logits (B, C, V) fp32, cache), the cache updated in place."""
    _check_ported(cfg)
    dev = params["embed"]["table"].device
    tokens = torch.as_tensor(tokens, device=dev)
    b, c = tokens.shape
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    if pos.ndim == 0:
        pos = pos.expand(b)
    n_tok = torch.full((b,), c, dtype=torch.int64, device=dev) \
        if n_tok is None else torch.as_tensor(n_tok, device=dev).long()
    x = nn.embed(params["embed"], tokens)
    t = cfg.spiking.time_steps
    x = x[None].expand(t, *x.shape).reshape(-1, *x.shape[1:])
    layers = cache["layers"]
    for i in range(cfg.num_layers):
        cache_l = {key: leaf[i] for key, leaf in layers.items()}
        x = _decode_layer(_layer(params, i), cfg, x, cache_l, pos, n_tok)
    x = x.reshape(t, -1, *x.shape[1:]).mean(dim=0)
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
