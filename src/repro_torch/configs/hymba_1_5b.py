"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads
[arXiv:2411.13676; hf]. Meta-tokens omitted, as in the JAX package."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    attn_type="full", act="silu", gated=True, rope_theta=10000.0,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=5, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, dtype="float32",
    ssm=SSMConfig(d_state=4, d_conv=4, expand=2))
