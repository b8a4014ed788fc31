"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, sliding-window attention
[arXiv:2401.16818]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000,
    attn_type="swa", window=4096, act="silu", gated=True,
    rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=96, num_heads=4, num_kv_heads=2, head_dim=24,
    d_ff=192, vocab_size=512, window=16, dtype="float32")
