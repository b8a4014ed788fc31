"""Assigned input-shape sets (LM transformer shapes: seq_len x global_batch).

decode_* / long_* lower ``serve_step`` (one token against a seq_len KV
cache), not ``train_step``. long_500k runs only for sub-quadratic archs
(SWA / local:global / SSM / hybrid); pure full-attention archs skip it
(registry.NO_LONG_CONTEXT, DESIGN.md §5).
"""
from .base import RunShape

TRAIN_4K = RunShape("train_4k", seq_len=4096, global_batch=256, mode="train")
PREFILL_32K = RunShape("prefill_32k", seq_len=32768, global_batch=32,
                       mode="prefill")
DECODE_32K = RunShape("decode_32k", seq_len=32768, global_batch=128,
                      mode="decode")
LONG_500K = RunShape("long_500k", seq_len=524288, global_batch=1,
                     mode="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
LM_SHAPE_NAMES = tuple(SHAPES)
