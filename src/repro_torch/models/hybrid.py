"""Hymba-style hybrid (hymba-1.5b): GQA attention and a selective-SSM
branch in parallel in every block (arXiv:2411.13676).

Mirrors ``repro.models.hybrid``: both branches read the same normed
input; their outputs are rms-normed each and averaged, then a gated MLP
follows. Meta-tokens are omitted, as in JAX. Plain PyTorch, as JAX's is
jnp: attention is the dense family's (``transformer._project_qkv``,
``_attend_full_seq``), the SSM branch :mod:`.ssm`'s loop.

* Decode writes one token a step into a ring of the cache's length (slot
  ``pos % s_len``, the ring's entry tags shared by the rows), as JAX's;
  the SSM branch carries its state and conv buffer. The cache is updated
  in place and returned.
* A spiking hybrid (``cfg.spiking``) is refused, forward and decode: the
  reference sends the rotated, analog q / k / v straight into the binary
  engine, whose kernel (#7) takes {0,1} operands, and decodes with a
  softmax, so its own decode does not follow its forward (ROADMAP queue
  3). No kernel is launched for it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map
from . import nn, ssm
from .transformer import _layer as _layer_params
from .transformer import (_attend_full_seq, _project_qkv, _stacked_layers,
                          dtype_of)


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
        "mamba": ssm.ssm_init(gen, cfg),
        "norm_attn": nn.rmsnorm_init(cfg.d_model, dt),
        "norm_mamba": nn.rmsnorm_init(cfg.d_model, dt),
        "ln2": nn.rmsnorm_init(cfg.d_model, dt),
        "mlp": nn.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated,
                           dtype=dt),
    }
    if cfg.spiking is not None:
        p["delta"] = torch.tensor(cfg.spiking.attn_threshold_init,
                                  dtype=torch.float32)
    return p


def init(cfg: ModelConfig, seed: int = 0, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    """Params in the JAX layout (layer leaves stacked on a leading axis)
    from a ``torch.Generator`` on ``device`` (the GPU by default) seeded
    with ``seed`` (not JAX's numbers: tests convert JAX's params)."""
    dev = resolve_device(device)
    gen = nn.generator(dev).manual_seed(seed)
    dt = dtype_of(cfg)
    params = {
        "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "layers": _stacked_layers(gen, cfg, (cfg.num_layers,), dev,
                                  _layer_init),
        "final_norm": nn.rmsnorm_init(cfg.d_model, dt),
        "lm_head": nn.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                  dtype=dt),
    }
    return tree_map(lambda a: a.to(dev), params)


def _refuse_spiking(cfg: ModelConfig):
    if cfg.spiking is not None:
        raise ValueError(
            f"{cfg.name}: a spiking hybrid is not run: the reference feeds "
            f"its analog rotated q / k / v to the binary engine, whose "
            f"kernel takes {{0,1}} operands, and decodes with a softmax "
            f"(ROADMAP queue 3)")


def _fuse(p, cfg: ModelConfig, x, attn, m_out):
    """The branches' average, the residual, then the gated MLP."""
    fused = 0.5 * (nn.rmsnorm(p["norm_attn"], attn, cfg.norm_eps) +
                   nn.rmsnorm(p["norm_mamba"], m_out, cfg.norm_eps))
    x = x + fused
    h2 = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + nn.mlp(p["mlp"], h2, cfg.act)


def _layer(p, cfg: ModelConfig, x, positions):
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, h, positions, repeat_kv=True)
    kind = "window" if cfg.attn_type == "swa" else "full"
    attn = _attend_full_seq(cfg, kind, q, k, v)
    attn = nn.linear(p["wo"], attn.reshape(*x.shape[:-1], cfg.q_dim))
    m_out, _, _ = ssm.ssm_forward(p["mamba"], h, cfg)
    return _fuse(p, cfg, x, attn, m_out)


def _head(params, cfg: ModelConfig, x):
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return nn.linear(params["lm_head"], x).float()


def forward(params, cfg: ModelConfig, batch, *, train: bool = False,
            inputs_embeds: Optional[torch.Tensor] = None):
    """batch: {'tokens': (B, S)}; returns (logits (B, S, V) fp32, {})."""
    _refuse_spiking(cfg)
    x = nn.embed(params["embed"], batch["tokens"]) if inputs_embeds is None \
        else inputs_embeds
    positions = torch.arange(x.shape[-2], device=x.device)
    for i in range(cfg.num_layers):
        x = _layer(_layer_params(params, i), cfg, x, positions)
    return _head(params, cfg, x), {}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, batch=None,
               params=None, chunk_headroom: int = 0, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """{'k', 'v': (L, B, max_len, KH, hd) in the activation dtype, 'pos':
    (L, max_len) int32 tags (-1 = empty), 'ssm': (L, B, di, N) fp32,
    'conv': (L, B, K-1, di)}, on ``device``."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    n = cfg.num_layers
    shape = (n, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev),
             "pos": torch.full((n, max_len), -1, dtype=torch.int32,
                               device=dev)}
    cache.update(ssm.zero_states(cfg, n, batch_size, dev))
    return cache


def decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                n_tok: Optional[torch.Tensor] = None):
    """tokens: (B, 1) int; pos: scalar, the token's position in every row.
    Returns (logits (B, 1, V) fp32, cache), the cache updated in place.
    JAX's takes no ``n_tok``; nor does the port's."""
    if n_tok is not None:
        raise TypeError(f"{cfg.name}: hybrid decode takes one token a row "
                        f"at a scalar position, no n_tok")
    _refuse_spiking(cfg)
    dev = params["embed"]["table"].device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev).reshape(())
    x = nn.embed(params["embed"], torch.as_tensor(tokens, device=dev))
    window = cfg.window if cfg.attn_type == "swa" else None
    for i in range(cfg.num_layers):
        lp = _layer_params(params, i)
        c = {key: leaf[i] for key, leaf in cache.items()}
        h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = _project_qkv(lp, cfg, h, pos.reshape(1))
        slot = (pos % c["k"].shape[1]).reshape(1)
        c["k"].index_copy_(1, slot, k.to(c["k"].dtype))
        c["v"].index_copy_(1, slot, v.to(c["v"].dtype))
        c["pos"].index_copy_(0, slot, pos.reshape(1).to(torch.int32))
        attn = nn.decode_attention(q, c["k"], c["v"], entry_pos=c["pos"],
                                   cur_pos=pos, window=window)
        attn = nn.linear(lp["wo"], attn.reshape(x.shape[0], 1, cfg.q_dim))
        m_out, h_ssm, conv = ssm.ssm_decode(lp["mamba"], h, cfg, c["ssm"],
                                            c["conv"])
        c["ssm"].copy_(h_ssm)
        c["conv"].copy_(conv)
        x = _fuse(lp, cfg, x, attn, m_out)
    return _head(params, cfg, x), cache
