"""Whisper-style encoder-decoder (whisper-small's backbone).

Mirrors ``repro.models.encdec``: the conv frontend is a stub (the batch
carries precomputed frame embeddings, (B, F, d_model)); the backbone is
pre-LN multi-head attention with biases (none on K), sinusoid encoder
positions, learned decoder positions, a GELU MLP (JAX's ``jax.nn.gelu``,
the tanh approximation) and the decoder embedding tied to the
unembedding. Plain PyTorch, as JAX's is jnp (``nn.flash_attention``,
``nn.decode_attention``); no kernel of the port runs.

Positions past the learned table's 448 rows: the forward appends
sinusoid rows to it, while decode clamps the position to the table's
last row, as JAX's (so the two disagree there: ROADMAP queue 3). The
self-attention cache write takes JAX's ``dynamic_update_slice``
semantics: a position past the cache's last entry writes that entry.
Decode reads the cross-attention K / V that ``init_cache`` computed
from the batch's frames; the cache is updated in place and returned.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map
from . import nn
from .transformer import _stacked_layers, dtype_of

gelu = nn.activation("gelu")


def _mha_init(gen: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    return {
        "wq": nn.linear_init(gen, cfg.d_model, cfg.q_dim, bias=True,
                             dtype=dt),
        "wk": nn.linear_init(gen, cfg.d_model, cfg.q_dim, dtype=dt),
        "wv": nn.linear_init(gen, cfg.d_model, cfg.q_dim, bias=True,
                             dtype=dt),
        "wo": nn.linear_init(
            gen, cfg.q_dim, cfg.d_model, bias=True,
            std=1.0 / math.sqrt(cfg.q_dim * 2 * cfg.num_layers), dtype=dt),
    }


def _mlp_init(gen: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    return {"up": nn.linear_init(gen, cfg.d_model, cfg.d_ff, bias=True,
                                 dtype=dt),
            "down": nn.linear_init(gen, cfg.d_ff, cfg.d_model, bias=True,
                                   dtype=dt)}


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    return {"ln1": nn.layernorm_init(cfg.d_model, dt),
            "attn": _mha_init(gen, cfg),
            "ln2": nn.layernorm_init(cfg.d_model, dt),
            "mlp": _mlp_init(gen, cfg)}


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    return {"ln1": nn.layernorm_init(cfg.d_model, dt),
            "self_attn": _mha_init(gen, cfg),
            "ln_x": nn.layernorm_init(cfg.d_model, dt),
            "cross_attn": _mha_init(gen, cfg),
            "ln2": nn.layernorm_init(cfg.d_model, dt),
            "mlp": _mlp_init(gen, cfg)}


def init(cfg: ModelConfig, seed: int = 0, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    """Params in the JAX layout (encoder and decoder layer leaves stacked
    on a leading axis) from a ``torch.Generator`` on ``device`` (the GPU
    by default) seeded with ``seed`` (not JAX's numbers: tests convert
    JAX's params)."""
    dev = resolve_device(device)
    gen = nn.generator(dev).manual_seed(seed)
    dt = dtype_of(cfg)
    params = {
        "enc_layers": _stacked_layers(gen, cfg, (cfg.encoder_layers,), dev,
                                      _enc_layer_init),
        "enc_final_norm": nn.layernorm_init(cfg.d_model, dt),
        "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "pos_embed": nn.normal(gen, (cfg.max_position_embeddings,
                                     cfg.d_model), 0.01, dt),
        "dec_layers": _stacked_layers(gen, cfg, (cfg.num_layers,), dev,
                                      _dec_layer_init),
        "final_norm": nn.layernorm_init(cfg.d_model, dt),
    }
    return tree_map(lambda a: a.to(dev), params)


def _heads(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], cfg.num_heads, cfg.head_dim)


def _mha(p, cfg: ModelConfig, xq, xkv, *, causal: bool):
    q = _heads(cfg, nn.linear(p["wq"], xq))
    k = _heads(cfg, nn.linear(p["wk"], xkv))
    v = _heads(cfg, nn.linear(p["wv"], xkv))
    out = nn.flash_attention(q, k, v, causal=causal)
    return nn.linear(p["wo"], out.reshape(*xq.shape[:-1], cfg.q_dim))


def _mlp(p, h):
    return nn.linear(p["down"], gelu(nn.linear(p["up"], h)))


def _layer(stack, i: int):
    return tree_map(lambda a: a[i], stack)


def encode(params, cfg: ModelConfig, audio_embeds: torch.Tensor, *,
           train: bool = False) -> torch.Tensor:
    """audio_embeds: (B, F, d_model) stub frame embeddings -> the encoder's
    output (B, F, d_model), in their dtype."""
    x = audio_embeds + nn.sinusoid_positions(
        audio_embeds.shape[1], cfg.d_model,
        device=audio_embeds.device).to(audio_embeds.dtype)[None]
    for i in range(cfg.encoder_layers):
        p = _layer(params["enc_layers"], i)
        h = nn.layernorm(p["ln1"], x)
        x = x + _mha(p["attn"], cfg, h, h, causal=False)
        x = x + _mlp(p["mlp"], nn.layernorm(p["ln2"], x))
    return nn.layernorm(params["enc_final_norm"], x)


def _dec_layer(p, cfg: ModelConfig, x, enc_out):
    h = nn.layernorm(p["ln1"], x)
    x = x + _mha(p["self_attn"], cfg, h, h, causal=True)
    x = x + _mha(p["cross_attn"], cfg, nn.layernorm(p["ln_x"], x), enc_out,
                 causal=False)
    return x + _mlp(p["mlp"], nn.layernorm(p["ln2"], x))


def forward(params, cfg: ModelConfig, batch, *, train: bool = False):
    """batch: {'tokens': (B, S), 'audio_embeds': (B, F, D)}; returns
    (logits (B, S, V) fp32, {})."""
    enc_out = encode(params, cfg, batch["audio_embeds"], train=train)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    pos = params["pos_embed"]
    if s > pos.shape[0]:   # past the learned positions: sinusoid rows
        pos = torch.cat([pos, nn.sinusoid_positions(
            s - pos.shape[0], cfg.d_model, device=pos.device).to(pos.dtype)])
    x = nn.embed(params["embed"], tokens) + pos[None, :s]
    for i in range(cfg.num_layers):
        x = _dec_layer(_layer(params["dec_layers"], i), cfg, x, enc_out)
    x = nn.layernorm(params["final_norm"], x)
    return nn.unembed(params["embed"], x), {}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, batch=None,
               params=None, chunk_headroom: int = 0, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """The self-attention cache {'k', 'v': (L, B, max_len, H, hd), 'pos':
    (L, max_len) int32 tags (-1 = empty)} and the cross-attention K / V
    {'cross_k', 'cross_v': (L, B, F, H, hd)}: with ``params`` and
    ``batch`` ({'audio_embeds'}) computed from the encoder's output of
    the batch's frames (in their dtype), else zeros of ``encoder_seq``
    frames."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    n = cfg.num_layers

    def zeros(s):
        return torch.zeros((n, batch_size, s, cfg.num_heads, cfg.head_dim),
                           dtype=dt, device=dev)
    cache = {"k": zeros(max_len), "v": zeros(max_len),
             "pos": torch.full((n, max_len), -1, dtype=torch.int32,
                               device=dev),
             "cross_k": zeros(cfg.encoder_seq),
             "cross_v": zeros(cfg.encoder_seq)}
    if params is not None and batch is not None:
        enc_out = encode(params, cfg, torch.as_tensor(
            batch["audio_embeds"]).to(dev))
        layers = [_layer(params["dec_layers"], i)["cross_attn"]
                  for i in range(n)]
        cache["cross_k"] = torch.stack([
            _heads(cfg, nn.linear(p["wk"], enc_out)) for p in layers])
        cache["cross_v"] = torch.stack([
            _heads(cfg, nn.linear(p["wv"], enc_out)) for p in layers])
    return cache


def decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                n_tok: Optional[torch.Tensor] = None):
    """tokens: (B, 1) int; pos: scalar, the token's position in every row.
    Returns (logits (B, 1, V) fp32, cache), the cache updated in place.
    JAX's takes no ``n_tok``; nor does the port's."""
    if n_tok is not None:
        raise TypeError(f"{cfg.name}: encdec decode takes one token a row "
                        f"at a scalar position, no n_tok")
    dev = params["embed"]["table"].device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev).reshape(())
    x = nn.embed(params["embed"], torch.as_tensor(tokens, device=dev))
    pe = params["pos_embed"]
    x = x + pe[pos.clamp(0, pe.shape[0] - 1)].reshape(1, 1, cfg.d_model)
    # JAX's dynamic_update_slice: the write's start clamps into the cache
    slot = pos.clamp(0, cache["k"].shape[2] - 1).reshape(1)
    f = cache["cross_k"].shape[2]
    cross_pos = torch.arange(f, device=dev)
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        c = {key: leaf[i] for key, leaf in cache.items()}
        sa = lp["self_attn"]
        h = nn.layernorm(lp["ln1"], x)
        q = _heads(cfg, nn.linear(sa["wq"], h))
        c["k"].index_copy_(1, slot, _heads(cfg, nn.linear(sa["wk"], h)).to(
            c["k"].dtype))
        c["v"].index_copy_(1, slot, _heads(cfg, nn.linear(sa["wv"], h)).to(
            c["v"].dtype))
        c["pos"].index_copy_(0, slot, pos.reshape(1).to(torch.int32))
        attn = nn.decode_attention(q, c["k"], c["v"], entry_pos=c["pos"],
                                   cur_pos=pos)
        x = x + nn.linear(sa["wo"], attn.reshape(x.shape[0], 1, cfg.q_dim))
        # cross attention against the precomputed encoder K / V
        ca = lp["cross_attn"]
        qx = _heads(cfg, nn.linear(ca["wq"], nn.layernorm(lp["ln_x"], x)))
        attn = nn.decode_attention(qx, c["cross_k"], c["cross_v"],
                                   entry_pos=cross_pos, cur_pos=f)
        x = x + nn.linear(ca["wo"], attn.reshape(x.shape[0], 1, cfg.q_dim))
        x = x + _mlp(lp["mlp"], nn.layernorm(lp["ln2"], x))
    x = nn.layernorm(params["final_norm"], x)
    return nn.unembed(params["embed"], x), cache
