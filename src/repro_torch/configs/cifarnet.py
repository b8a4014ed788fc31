"""CIFAR-Net — FireFly v2's spiking conv network (Table IV footnote 3):
3x32x32-32c3-256c3-256c3-mp2-256c3-256c3-256c3-mp2-512c3-mp2-1024c3-ap-10,
T_s=4. Same shape as ``repro.configs``; the conv ladder itself is fixed
(``models/spikingformer.CIFARNET_SPEC``). It has no engine: its convs,
BatchNorms, LIF neurons and pools are plain PyTorch, as they are jnp in
JAX, and launch no kernel."""
from repro_torch.core.spiking import SpikingConfig
from .base import ModelConfig, VisionSpec

CONFIG = ModelConfig(
    name="cifarnet", family="cifarnet",
    num_layers=8, d_model=1024, num_heads=1, num_kv_heads=1, head_dim=1,
    d_ff=1024, vocab_size=10,
    vision=VisionSpec(img_size=32, in_channels=3),
    spiking=SpikingConfig(time_steps=4),
)

# the smoke config shrinks the image and the time steps only
SMOKE = CONFIG.replace(
    vision=VisionSpec(img_size=16, in_channels=3),
    spiking=SpikingConfig(time_steps=2), dtype="float32")
