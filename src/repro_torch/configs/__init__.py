"""Config registry: ``get_config(name)`` for the architectures the port
runs: the four dense decoders (nemotron-4-15b, gemma3-12b,
h2o-danube-3-4b, granite-20b), the two MoE decoders (kimi-k2-1t-a32b,
deepseek-moe-16b), the recurrent, hybrid, encoder-decoder and
vision-language models (rwkv6-3b, hymba-1.5b, whisper-small,
llava-next-mistral-7b), the two Spikingformer vision configs, the
spiking LM and CIFAR-Net. ``configs.shapes`` holds the LM run shapes."""
from . import (cifarnet, deepseek_moe_16b, gemma3_12b, granite_20b,
               h2o_danube3_4b, hymba_1_5b, kimi_k2_1t_a32b,
               llava_next_mistral_7b, nemotron_4_15b, rwkv6_3b,
               spikingformer_4_256, spikingformer_8_512, spikingformer_lm,
               whisper_small)
from .base import (FrontendConfig, ModelConfig, MoEConfig, RWKVConfig,
                   SSMConfig)

_MODULES = {
    "nemotron-4-15b": nemotron_4_15b,
    "gemma3-12b": gemma3_12b,
    "h2o-danube-3-4b": h2o_danube3_4b,
    "granite-20b": granite_20b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "rwkv6-3b": rwkv6_3b,
    "hymba-1.5b": hymba_1_5b,
    "whisper-small": whisper_small,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "spikingformer-4-256": spikingformer_4_256,
    "spikingformer-8-512": spikingformer_8_512,
    "spikingformer-lm": spikingformer_lm,
    "cifarnet": cifarnet,
}

DENSE_ARCHS = tuple(list(_MODULES)[:4])
MOE_ARCHS = tuple(list(_MODULES)[4:6])
# one a family: rwkv, hybrid, encdec, vlm
OTHER_ARCHS = tuple(list(_MODULES)[6:10])
ALL_ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
