"""Spikingformer-4-256 — the paper's CIFAR-10 workload (§V-A): 4 encoder
blocks, embedding dim 256, T_s=4, binary attention, pre-neuron
residuals. Same shape and engine knobs as ``repro.configs``."""
from repro_torch.core.engine import EngineConfig
from repro_torch.core.spiking import SpikingConfig
from .base import ModelConfig, VisionSpec

CONFIG = ModelConfig(
    name="spikingformer-4-256", family="spikingformer",
    num_layers=4, d_model=256, num_heads=8, num_kv_heads=8, head_dim=32,
    d_ff=1024, vocab_size=10,
    vision=VisionSpec(img_size=32, in_channels=3, sps_stages=2),
    spiking=SpikingConfig(time_steps=4),
    # overlap='auto' runs the fused layer program on the card
    # (core/engine.resolve_overlap)
    engine=EngineConfig(sparse="auto", overlap="auto"),
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=128,
    vision=VisionSpec(img_size=16, in_channels=3, sps_stages=2),
    spiking=SpikingConfig(time_steps=2), dtype="float32")
