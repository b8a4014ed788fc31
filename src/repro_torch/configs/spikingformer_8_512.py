"""Spikingformer-8-512 — the paper's ImageNet workload (§V-A): 8 encoder
blocks, embedding dim 512, T_s=4, 224x224 input (196 tokens after the
4-stage SPS)."""
from repro_torch.core.engine import EngineConfig
from repro_torch.core.spiking import SpikingConfig
from .base import ModelConfig, VisionSpec

CONFIG = ModelConfig(
    name="spikingformer-8-512", family="spikingformer",
    num_layers=8, d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=1000,
    vision=VisionSpec(img_size=224, in_channels=3, sps_stages=4),
    spiking=SpikingConfig(time_steps=4),
    engine=EngineConfig(sparse="auto", overlap="auto"),
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=128,
    vocab_size=10,
    vision=VisionSpec(img_size=32, in_channels=3, sps_stages=4),
    spiking=SpikingConfig(time_steps=2), dtype="float32")
