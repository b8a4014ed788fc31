"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch code model with multi-query attention
[arXiv:2405.04324; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    attn_type="full", act="gelu", gated=False, rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=1, head_dim=16,
    d_ff=256, vocab_size=512, dtype="float32")
