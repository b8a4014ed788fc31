"""Config dataclasses (those of ``repro.configs.base``: the vision
family, the dense token family, dense or spiking, the MoE family, and
the rwkv, hybrid, encdec and vlm families; JAX's ``remat``, a memory
policy that changes no value, has no knob here).
Every config module exports ``CONFIG`` (the published shape) and
``SMOKE`` (a reduced same-family config for CPU tests)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.engine import EngineConfig
from repro_torch.core.spiking import SpikingConfig


ATTN_TYPES = ("full", "swa", "local_global")
ACTIVATIONS = ("silu", "gelu", "relu2")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    first_k_dense: int = 0          # leading dense layers (deepseek/kimi style)
    first_dense_ff: int = 0         # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    normalize_topk: bool = True     # renormalize top-k routing weights


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    lora_mix: int = 32              # rank of data-dependent token-shift LoRA
    lora_decay: int = 64            # rank of data-dependent decay LoRA
    wkv_chunk: int = 0              # 0 = per-token scan; >0 = chunk-parallel
                                    # WKV (exact; see models/rwkv)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    kind: str                        # 'audio' | 'vision'
    num_embeds: int                  # frames / patches the stub provides
    embed_dim: int                   # pre-projector embedding dim
    projector_layers: int = 2        # mm projector MLP depth (vision)


@dataclasses.dataclass(frozen=True)
class VisionSpec:
    """Spikingformer / CIFAR-Net image input."""
    img_size: int = 32
    in_channels: int = 3
    sps_stages: int = 2              # maxpool stages in SPS (32->8 for CIFAR)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # a key of models/registry.FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention (token family)
    attn_type: str = "full"          # full | swa | local_global
    window: int = 4096
    global_every: int = 6            # local_global: one global layer per N
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # mlp (token family)
    act: str = "silu"                # silu | gelu | relu2
    gated: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_position_embeddings: int = 0  # >0 -> learned positions (whisper dec)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    frontend: Optional[FrontendConfig] = None
    vision: Optional[VisionSpec] = None
    encoder_layers: int = 0          # whisper encoder depth
    encoder_seq: int = 1500          # whisper frame count (stubbed frontend)
    spiking: Optional[SpikingConfig] = None
    # dual-engine dispatch installed around the forward by the step
    # builders (core/engine.py); None = no engine
    engine: Optional[EngineConfig] = None
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.attn_type not in ATTN_TYPES:
            raise ValueError(f"unknown attn_type {self.attn_type!r} "
                             f"(expected {'|'.join(ATTN_TYPES)})")
        if self.act not in ACTIVATIONS:
            raise ValueError(f"unknown act {self.act!r} "
                             f"(expected {'|'.join(ACTIVATIONS)})")
        for name in ("window", "global_every"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(self, name)}")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class RunShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"
