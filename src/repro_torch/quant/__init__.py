"""Symmetric integer weight quantization (the port of ``repro.quant``'s
serving quantizer; calibration and QAT are still to be ported)."""
from .quantize import (INT_BITS, dequantize_tree, dequantize_weight,
                       footprint_report, is_quantized, map_param_dicts,
                       pack_int4, quantize_tree, quantize_weight,
                       tree_nbytes, unpack_int4, weight_bits)

__all__ = ["INT_BITS", "dequantize_tree", "dequantize_weight",
           "footprint_report", "is_quantized", "map_param_dicts",
           "pack_int4", "quantize_tree", "quantize_weight", "tree_nbytes",
           "unpack_int4", "weight_bits"]
