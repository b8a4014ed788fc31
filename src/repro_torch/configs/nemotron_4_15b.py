"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU, non-gated MLP [arXiv:2402.16819]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000,
    attn_type="full", act="relu2", gated=False, rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=128, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, dtype="float32")
