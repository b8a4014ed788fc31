"""Model registry (the families the port runs so far).

Uniform API, as in ``repro.models.registry``:
  init(cfg, seed, device=)            -> params tree
  forward(params, cfg, batch, train=) -> (logits, aux)
  init_state(cfg, device=)            -> BatchNorm running stats
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from . import spikingformer

FAMILIES: Dict[str, ModuleType] = {"spikingformer": spikingformer}


def family_module(cfg: ModelConfig) -> ModuleType:
    if cfg.family == "cifarnet":
        raise NotImplementedError("the cifarnet family is not ported to "
                                  "PyTorch yet (ROADMAP queue 1 item 4)")
    try:
        return FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}") from None


def init(cfg: ModelConfig, seed: int = 0, *, device: DeviceLike = None):
    return family_module(cfg).init(cfg, seed, device=device)


def forward(params, cfg: ModelConfig, batch, *, train: bool = False, **kw):
    return family_module(cfg).forward(params, cfg, batch, train=train, **kw)


def init_state(cfg: ModelConfig, *, device: DeviceLike = None):
    return family_module(cfg).init_state(cfg, device=device)
