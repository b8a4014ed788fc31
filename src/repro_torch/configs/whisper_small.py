"""whisper-small [audio]: 12L enc + 12L dec, d_model=768 12H (MHA)
d_ff=3072 vocab=51865 — encoder-decoder; conv frontend stubbed (the batch
carries precomputed frame embeddings) [arXiv:2212.04356]."""
from .base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, encoder_layers=12, d_model=768, num_heads=12,
    num_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=51865,
    attn_type="full", act="gelu", gated=False,
    max_position_embeddings=448, encoder_seq=1500,
    frontend=FrontendConfig(kind="audio", num_embeds=1500, embed_dim=768),
)

SMOKE = CONFIG.replace(
    num_layers=2, encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, max_position_embeddings=64,
    encoder_seq=12, dtype="float32",
    frontend=FrontendConfig(kind="audio", num_embeds=12, embed_dim=64))
