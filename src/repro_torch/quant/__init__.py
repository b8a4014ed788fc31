"""Symmetric integer weight quantization (the port of ``repro.quant``):
the serving quantizer, PTQ range calibration (``calibrate``) and
quantization-aware training's fake-quant (``fake_quant``)."""
from .calibrate import DEFAULT_RATIOS, calibrate, logit_delta
from .qat import fake_quant, fake_quant_tree
from .quantize import (INT_BITS, dequantize_tree, dequantize_values,
                       dequantize_weight, footprint_report, is_quantized,
                       map_param_dicts, pack_int4, quantize_tree,
                       quantize_values, quantize_weight, symmetric_scale,
                       tree_nbytes, unpack_int4, weight_bits)

__all__ = ["DEFAULT_RATIOS", "INT_BITS", "calibrate", "dequantize_tree",
           "dequantize_values", "dequantize_weight", "fake_quant",
           "fake_quant_tree", "footprint_report", "is_quantized",
           "logit_delta", "map_param_dicts", "pack_int4", "quantize_tree",
           "quantize_values", "quantize_weight", "symmetric_scale",
           "tree_nbytes", "unpack_int4", "weight_bits"]
