"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, fine-grained experts, first
layer dense (d_ff 10944) [arXiv:2401.06066; hf]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    attn_type="full", act="silu", gated=True, rope_theta=10000.0,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2,
                  first_k_dense=1, first_dense_ff=10944,
                  capacity_factor=1.25),
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=96, num_heads=4, num_kv_heads=4, head_dim=24,
    d_ff=64, vocab_size=512, dtype="float32",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=48, num_shared=2,
                  first_k_dense=1, first_dense_ff=192,
                  capacity_factor=8.0))
