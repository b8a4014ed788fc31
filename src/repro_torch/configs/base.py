"""Config dataclasses (the subset of ``repro.configs.base`` the vision
family uses). Every config module exports ``CONFIG`` (the published
shape) and ``SMOKE`` (a reduced same-family config for CPU tests)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.engine import EngineConfig
from repro_torch.core.spiking import SpikingConfig


@dataclasses.dataclass(frozen=True)
class VisionSpec:
    """Spikingformer / CIFAR-Net image input."""
    img_size: int = 32
    in_channels: int = 3
    sps_stages: int = 2              # maxpool stages in SPS (32->8 for CIFAR)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # spikingformer | cifarnet
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    vision: Optional[VisionSpec] = None
    spiking: Optional[SpikingConfig] = None
    # dual-engine dispatch installed around the forward by the step
    # builders (core/engine.py); None = no engine
    engine: Optional[EngineConfig] = None
    dtype: str = "bfloat16"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class RunShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"
