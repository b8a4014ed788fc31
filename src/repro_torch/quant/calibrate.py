"""Post-training-quantization range calibration over a batch.

Port of ``repro.quant.calibrate``. Symmetric per-output-channel
quantization has one free knob: the clip point. :func:`calibrate` sweeps
a small grid of clip ratios, runs the quantized model on a calibration
batch and keeps the ratio whose logits sit closest to the unquantized
model's (mean |delta|): one global ratio, measured end to end, since
weight error reaches the logits through LIF thresholds and binary
attention, which no weight-space metric sees.

Each forward goes through ``registry.forward`` under the config's engine
(``engine_scope``, as the prefill step runs it), in inference mode, on
the params' device: on the card an eligible layer takes the layer
program's kernels, on the CPU the plain paths.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from .quantize import quantize_tree

DEFAULT_RATIOS = (1.0, 0.95, 0.9, 0.8)


def logit_delta(ref: torch.Tensor, out: torch.Tensor) -> Dict[str, float]:
    """Calibration distance between two logit tensors: mean |delta|, its
    normalized form (mae / std(ref), comparable across configs), the
    reference's std and the share of rows whose argmax agrees."""
    ref32, out32 = ref.float(), out.float()
    mae = float((out32 - ref32).abs().mean())
    # jnp.std: the population standard deviation
    std = float(ref32.std(unbiased=False))
    return {"logit_mae": mae,
            "logit_mae_rel": mae / max(std, 1e-12),
            "ref_std": std,
            "argmax_agree": float(
                (out32.argmax(-1) == ref32.argmax(-1)).float().mean())}


def _param_device(params: Any) -> torch.device:
    from repro_torch.tree import tree_leaves
    return tree_leaves(params)[0].device


def calibrate(cfg, params, batch, dtype: str = "int8", *,
              ratios: Sequence[float] = DEFAULT_RATIOS,
              state=None) -> Tuple[Any, Dict[str, Any]]:
    """PTQ calibration of a model's linears over one batch: one forward
    of ``params``, then one of ``quantize_tree(params, dtype,
    clip_ratio=r)`` for each ratio. Returns ``(best quantized tree,
    report)``; the report holds the dtype, the chosen candidate and every
    candidate's ``logit_delta``. ``state`` threads BatchNorm running stats
    (the stateful families)."""
    from repro_torch.core.engine import engine_scope
    from repro_torch.models import registry  # lazy: quant stays model-free

    dev = _param_device(params)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    kw = {} if state is None else {"state": state}

    def forward(tree):
        with engine_scope(cfg), torch.inference_mode():
            return registry.forward(tree, cfg, batch, train=False, **kw)[0]

    ref = forward(params)
    best = None
    candidates = []
    for r in ratios:
        qtree = quantize_tree(params, dtype, clip_ratio=r)
        d = logit_delta(ref, forward(qtree))
        candidates.append({"clip_ratio": r, **d})
        if best is None or d["logit_mae"] < best[1]["logit_mae"]:
            best = (qtree, {"clip_ratio": r, **d})
    report = {"dtype": dtype, "chosen": best[1], "candidates": candidates}
    return best[0], report
