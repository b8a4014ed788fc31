"""Config registry: ``get_config(name)`` for the architectures the port
runs so far (the two Spikingformer vision configs, the spiking LM and
CIFAR-Net)."""
from . import (cifarnet, spikingformer_4_256, spikingformer_8_512,
               spikingformer_lm)
from .base import ModelConfig

_MODULES = {
    "spikingformer-4-256": spikingformer_4_256,
    "spikingformer-8-512": spikingformer_8_512,
    "spikingformer-lm": spikingformer_lm,
    "cifarnet": cifarnet,
}

ALL_ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
