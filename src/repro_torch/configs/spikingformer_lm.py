"""spikingformer-lm — a token-domain Spikingformer: the dense transformer
family in spiking mode (LIF activations over T_s steps, binary causal
SSA), the serve path of the dual-engine overlay. Prefill runs the
binary engine over the whole prompt; decode runs token by token against
a bit-packed spike KV cache scored with AND-popcount. Same shape and
engine knobs as ``repro.configs.spikingformer_lm``."""
from repro_torch.core.engine import EngineConfig
from repro_torch.core.spiking import SpikingConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="spikingformer-lm", family="dense",
    num_layers=4, d_model=256, num_heads=8, num_kv_heads=8, head_dim=32,
    d_ff=1024, vocab_size=32000,
    attn_type="full", act="relu2", gated=False,
    spiking=SpikingConfig(time_steps=4),
    engine=EngineConfig(mode="auto", sparse="auto", overlap="auto"),
)

# head_dim=16 does not fill a 32-bit word: the packed KV cache pads the
# final word with zero bits (AND-popcount neutral)
SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=64,
    spiking=SpikingConfig(time_steps=2), dtype="float32")
