"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global sliding window, qk-norm, GeGLU
[hf:google/gemma-3 family]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    attn_type="local_global", global_every=6, window=1024,
    qk_norm=True, act="gelu", gated=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=4, global_every=2, window=8, d_model=96, num_heads=4,
    num_kv_heads=2, head_dim=24, d_ff=192, vocab_size=512,
    dtype="float32")
