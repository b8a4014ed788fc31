"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 + 1 shared, first layer dense —
trillion-param MoE (paper-table config) [arXiv:2501.*].

~1.04T parameters; active ~32B/token. One card holds two of its layers
at full width (one dense, one MoE: 19.9B parameters, 39.9 GB in bf16);
``chip_smoke.py`` and ``launch/profile.py`` cut it to those.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840,
    attn_type="full", act="silu", gated=True, rope_theta=50000.0,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048, num_shared=1,
                  first_k_dense=1, first_dense_ff=18432,
                  capacity_factor=1.25),
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=96, num_heads=4, num_kv_heads=2, head_dim=24,
    d_ff=64, vocab_size=512, dtype="float32",
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=64, num_shared=1,
                  first_k_dense=1, first_dense_ff=192,
                  capacity_factor=8.0))
