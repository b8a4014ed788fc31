"""Step builders (the inference step so far).

As in ``repro.launch.steps``, every builder wraps its forward in
``engine_scope(cfg)``, so one config knob (``ModelConfig.engine``) drives
the dual-engine dispatch of the whole forward.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import engine_scope
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import registry


def build_prefill_step(cfg: ModelConfig, *,
                       device: DeviceLike = None) -> Callable:
    """Inference forward: (params, batch) -> logits, on ``device`` (the
    GPU by default). Like the JAX step it passes no BN state, so the
    forward runs on ``init_state`` (mean 0, var 1)."""
    dev = resolve_device(device)

    def prefill_step(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        with engine_scope(cfg), torch.inference_mode():
            logits, _ = registry.forward(params, cfg, batch, train=False)
        return logits
    return prefill_step
