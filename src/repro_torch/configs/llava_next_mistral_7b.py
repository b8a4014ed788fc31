"""llava-next-mistral-7b [vlm]: mistral-7b backbone (32L d_model=4096 32H
GQA kv=8 d_ff=14336 vocab=32000, SWA 4096) + anyres vision tiling stub
(the batch carries precomputed patch embeddings; the mm projector is
implemented) [hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from .base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    attn_type="swa", window=4096, act="silu", gated=True,
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="vision", num_embeds=2880, embed_dim=1024),
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=96, num_heads=4, num_kv_heads=2, head_dim=24,
    d_ff=192, vocab_size=512, window=16, dtype="float32",
    frontend=FrontendConfig(kind="vision", num_embeds=8, embed_dim=32))
