"""Model registry: every family of the JAX package. The Spikingformer
vision family, CIFAR-Net, the dense decoder family (dense and spiking),
the MoE family, RWKV, the attention / SSM hybrid, the encoder-decoder
and the vision-language model.

Uniform API, as in ``repro.models.registry``:
  init(cfg, seed, device=)                     -> params tree
  forward(params, cfg, batch, train=)          -> (logits, aux)
  init_state(cfg, device=)                     -> BatchNorm running stats
  init_cache(cfg, batch, max_len, ...)         -> decode cache (LM family)
  decode_step(params, cfg, cache, tokens, pos) -> (logits, cache)
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from . import encdec, hybrid, moe, rwkv, spikingformer, transformer, vlm

FAMILIES: Dict[str, ModuleType] = {"spikingformer": spikingformer,
                                   "cifarnet": spikingformer,
                                   "dense": transformer,
                                   "moe": moe,
                                   "rwkv": rwkv,
                                   "hybrid": hybrid,
                                   "encdec": encdec,
                                   "vlm": vlm}
# the JAX package's families that the port does not run: none since
# every family landed (the list callers read stays, empty)
UNPORTED: Tuple[str, ...] = ()
# families without an autoregressive decode step
NO_DECODE = {"spikingformer", "cifarnet"}
# families whose decode step carries per-slot state (vector positions,
# validity tags, chunked bites, slot invalidation): what the
# continuous-batching server needs, as JAX's (the other token families
# decode one token a row at a scalar position, through build_serve_step)
SLOTTED_DECODE = {"dense", "vlm"}


def family_module(cfg: ModelConfig) -> ModuleType:
    try:
        return FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}") from None


def init(cfg: ModelConfig, seed: int = 0, *, device: DeviceLike = None,
         **kw):
    """``kw``: the family's own init options (MoE: ``keep``)."""
    return family_module(cfg).init(cfg, seed, device=device, **kw)


def forward(params, cfg: ModelConfig, batch, *, train: bool = False, **kw):
    return family_module(cfg).forward(params, cfg, batch, train=train, **kw)


def init_state(cfg: ModelConfig, *, device: DeviceLike = None):
    if cfg.family in ("spikingformer", "cifarnet"):
        return family_module(cfg).init_state(cfg, device=device)
    return None


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, batch=None,
               params=None, chunk_headroom: int = 0, *,
               device: DeviceLike = None):
    if chunk_headroom and not supports_slots(cfg):
        raise ValueError(f"{cfg.family} decode takes no chunked-prefill "
                         f"bites")
    return family_module(cfg).init_cache(
        cfg, batch_size, max_len, batch=batch, params=params,
        chunk_headroom=chunk_headroom, device=device)


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, n_tok=None):
    return family_module(cfg).decode_step(params, cfg, cache, tokens, pos,
                                          n_tok=n_tok)


def invalidate_slots(cfg: ModelConfig, cache, slot_mask):
    """Reset the validity tags of masked slots (continuous-batching
    admission). Slotted-decode families only."""
    if not supports_slots(cfg):
        raise ValueError(f"{cfg.family} has no per-slot decode state")
    return family_module(cfg).invalidate_slots(cache, slot_mask)


def has_decode(cfg: ModelConfig) -> bool:
    return cfg.family not in NO_DECODE


def supports_slots(cfg: ModelConfig) -> bool:
    return cfg.family in SLOTTED_DECODE
