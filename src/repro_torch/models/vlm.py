"""LLaVA-NeXT-style vision-language model (llava-next-mistral-7b): the
mistral-7b backbone behind a stubbed anyres vision frontend.

Mirrors ``repro.models.vlm``: the batch carries precomputed patch
embeddings (B, P, vision_dim); the mm projector (a GELU MLP, JAX's
``jax.nn.gelu``: the tanh approximation) maps them to d_model, and they
are prepended to the text's embeddings. The backbone is the dense
family's (``models/transformer``, sliding-window attention), and so are
its cache, its decode step (text continuation after a multimodal
prefill, per-slot positions and chunked bites) and its slot
invalidation: the family serves through ``BatchedServer``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map
from . import nn, transformer

# the projector's generator is seeded apart from the backbone's
_PROJECTOR_SEED = 1 << 20


def init(cfg: ModelConfig, seed: int = 0, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    """The backbone's params (``transformer.init``) and ``mm_projector``,
    a list of ``frontend.projector_layers`` linears with biases
    (vision_dim -> d_model, then d_model -> d_model)."""
    dev = resolve_device(device)
    params = transformer.init(cfg, seed, device=dev)
    gen = nn.generator(dev).manual_seed(seed + _PROJECTOR_SEED)
    dt = transformer.dtype_of(cfg)
    fr = cfg.frontend
    proj = [nn.linear_init(gen, fr.embed_dim, cfg.d_model, bias=True,
                           dtype=dt)]
    for _ in range(1, fr.projector_layers):
        proj.append(nn.linear_init(gen, cfg.d_model, cfg.d_model, bias=True,
                                   dtype=dt))
    params["mm_projector"] = tree_map(lambda a: a.to(dev), proj)
    return params


def project_patches(params, patch_embeds: torch.Tensor) -> torch.Tensor:
    x = patch_embeds
    for i, p in enumerate(params["mm_projector"]):
        if i:
            x = nn.activation("gelu")(x)
        x = nn.linear(p, x)
    return x


def forward(params, cfg: ModelConfig, batch, *, train: bool = False):
    """batch: {'tokens': (B, S_text), 'patch_embeds': (B, P, vision_dim)};
    the sequence is [projected patches ; text], P + S_text long. Returns
    (logits (B, P + S_text, V) fp32, {})."""
    vis = project_patches(params, batch["patch_embeds"])
    txt = nn.embed(params["embed"], batch["tokens"])
    embeds = torch.cat([vis.to(txt.dtype), txt], dim=1)
    return transformer.forward(params, cfg, batch, train=train,
                               inputs_embeds=embeds)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, batch=None,
               params=None, chunk_headroom: int = 0, *,
               device: DeviceLike = None):
    return transformer.init_cache(cfg, batch_size, max_len,
                                  chunk_headroom=chunk_headroom,
                                  device=device)


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, n_tok=None):
    """Text-token continuation after a multimodal prefill."""
    return transformer.decode_step(params, cfg, cache, tokens, pos,
                                   n_tok=n_tok)


# the cache layout is the transformer's: the same slot invalidation
invalidate_slots = transformer.invalidate_slots
