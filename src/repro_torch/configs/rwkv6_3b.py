"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536
— RWKV-6 "Finch", data-dependent decay [arXiv:2404.05892; hf].

The binary engine does not apply (no QK^T): no kernel of the port runs.
"""
from .base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    rwkv=RWKVConfig(head_size=64, lora_mix=32, lora_decay=64,
                    wkv_chunk=32),  # chunk-parallel WKV
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, dtype="float32",
    rwkv=RWKVConfig(head_size=16, lora_mix=8, lora_decay=8))
