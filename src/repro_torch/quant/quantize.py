"""Symmetric per-output-channel weight quantization.

Port of ``repro.quant.quantize``. fp32/bf16 param trees become

    {"qw": int8 (..., K, N),          "scale": fp32 (..., N) [, "b"]}   int8
    {"qw": uint8 (..., ceil(K/2), N), "scale": fp32 (..., N) [, "b"]}   int4

with ``scale[n] = amax_k |w[k, n]| / qmax``; int4 packs two two's-
complement nibbles per byte along K. Codes and scales equal the JAX
quantizer's bitwise:

* the dyadic scale ``2^ceil(log2 s)`` takes its exponent from
  ``torch.frexp`` (exact), not from a float ``log2``: the ceiling of
  XLA's fp32 log2 equals the exact one on 4e5 sampled scales, while
  ``torch.log2``'s crosses an integer on a few in 10^5;
* ``torch.round`` rounds half to even, as ``jnp.round`` does.

Leading axes beyond (K, N) are stacked layer dims.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

INT_BITS = {"int8": 8, "int4": 4}
QMAX = {8: 127, 4: 7}
_EPS = 1e-12


def symmetric_scale(x: torch.Tensor, bits: int, *, axis=None,
                    dyadic: bool = False,
                    clip_ratio: float = 1.0) -> torch.Tensor:
    """``max(amax(|x|) * clip_ratio, 1e-12) / qmax`` over ``axis`` (None:
    the whole tensor); ``dyadic`` rounds it up to a power of two."""
    ax = x.float().abs()
    amax = ax.amax() if axis is None else ax.amax(dim=axis)
    scale = torch.clamp_min(amax * clip_ratio, _EPS) / QMAX[bits]
    if dyadic:
        m, e = torch.frexp(scale)              # scale = m 2^e, m in [0.5, 1)
        e = torch.where(m == 0.5, e - 1, e)    # ceil(log2 scale), exactly
        # 2^e built from its exponent bits: exact, as JAX's ldexp
        scale = ((e + 127).to(torch.int32) << 23).view(torch.float32)
    return scale


def quantize_values(x: torch.Tensor, scale: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Round-to-nearest-even codes in [-qmax, qmax] as int8."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -QMAX[bits], QMAX[bits]).to(torch.int8)


def dequantize_values(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) int8 values in [-8, 7] -> (..., ceil(K/2), N) uint8:
    low nibble the even K row, high nibble the odd one; an odd K pads one
    zero row."""
    if q.shape[-2] % 2:
        q = torch.nn.functional.pad(q, (0, 0, 0, 1))
    u = q.to(torch.uint8) & 0xF
    return u[..., 0::2, :] | (u[..., 1::2, :] << 4)


def unpack_int4(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., ceil(k/2), N) uint8 ->
    (..., k, N) int8, nibbles sign-extended, the pad row dropped."""
    pairs = torch.stack([packed & 0xF, packed >> 4], dim=-2)
    inter = pairs.reshape(*packed.shape[:-2], 2 * packed.shape[-2],
                          packed.shape[-1])
    signed = (inter.to(torch.int8) ^ 8) - 8
    return signed[..., :k, :]


def quantize_weight(w: torch.Tensor, dtype: str = "int8", *,
                    dyadic: bool = False,
                    clip_ratio: float = 1.0) -> Dict[str, torch.Tensor]:
    """(..., K, N) weight -> {"qw", "scale"}; int4 packs nibbles only for
    even K (an odd-K int4 linear keeps int8-stored 4-bit codes)."""
    bits = INT_BITS[dtype]
    scale = symmetric_scale(w, bits, axis=-2, dyadic=dyadic,
                            clip_ratio=clip_ratio)
    q = quantize_values(w, scale[..., None, :], bits)
    if dtype == "int4" and w.shape[-2] % 2 == 0:
        q = pack_int4(q)
    return {"qw": q, "scale": scale.float()}


def weight_bits(p: Dict[str, Any]) -> int:
    """4 or 8, from the stored dtype (uint8 = packed nibbles)."""
    return 4 if p["qw"].dtype == torch.uint8 else 8


def dequantize_weight(p: Dict[str, Any], k: Optional[int] = None,
                      dtype=torch.float32) -> torch.Tensor:
    qw = p["qw"]
    if qw.dtype == torch.uint8:
        qw = unpack_int4(qw, 2 * qw.shape[-2] if k is None else k)
    return dequantize_values(qw, p["scale"][..., None, :], dtype)


def is_quantized(p: Any) -> bool:
    return isinstance(p, dict) and "qw" in p


def _is_linear_params(node: Any) -> bool:
    """{"w": (..., K, N) [, "b"]} with a 2-D or stacked 3-D weight; conv
    kernels, embedding tables and norm scales do not match."""
    return (isinstance(node, dict) and "w" in node
            and isinstance(node["w"], torch.Tensor)
            and node["w"].ndim in (2, 3))


def map_param_dicts(tree: Any, predicate: Callable[[Any], bool],
                    fn: Callable[[str, Any], Any]) -> Any:
    """Rebuild a param tree, applying ``fn('/'-joined path, node)`` to
    every dict node that matches ``predicate``."""
    def walk(path, node):
        if predicate(node):
            return fn("/".join(path), node)
        if isinstance(node, dict):
            return {k: walk(path + (str(k),), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            seq = [walk(path + (str(i),), v) for i, v in enumerate(node)]
            return type(node)(seq) if isinstance(node, tuple) else seq
        return node
    return walk((), tree)


def quantize_tree(params: Any, dtype: str = "int8", *,
                  dyadic: bool = False, clip_ratio: float = 1.0,
                  select: Optional[Callable[[str], bool]] = None) -> Any:
    """Quantize every eligible linear of a param tree; biases and every
    other leaf pass through. ``select`` filters by '/'-joined path."""
    if dtype not in INT_BITS:
        raise ValueError(f"unknown quantized dtype {dtype!r} "
                         f"(expected one of {sorted(INT_BITS)})")

    def visit(path, node):
        if select is not None and not select(path):
            return node
        out = {k: v for k, v in node.items() if k != "w"}
        out.update(quantize_weight(node["w"], dtype, dyadic=dyadic,
                                   clip_ratio=clip_ratio))
        return out

    return map_param_dicts(params, _is_linear_params, visit)


def dequantize_tree(params: Any, dtype=torch.float32) -> Any:
    """Every {"qw", "scale"} node back to {"w"} in ``dtype``."""
    def visit(path, node):
        out = {k: v for k, v in node.items() if k not in ("qw", "scale")}
        out["w"] = dequantize_weight(node, dtype=dtype)
        return out
    return map_param_dicts(params, is_quantized, visit)


def _flat_leaves(tree: Any, path: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def tree_nbytes(tree: Any) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in _flat_leaves(tree))


def footprint_report(ref_params: Any, quant_params: Any) -> Dict[str, Any]:
    """Weight-footprint compression of a quantized tree: quantized-leaf
    bytes (qw + their scales) against the same weights in the reference
    tree, and the whole trees' bytes."""
    nbytes = lambda t: t.numel() * t.element_size()
    ref_flat = dict(_flat_leaves(ref_params))
    q_flat = dict(_flat_leaves(quant_params))
    q_bytes = ref_bytes = 0
    for path, leaf in q_flat.items():
        # a scale counts only beside its qw: norm scales are not weights
        if path.endswith("/qw") or (path.endswith("/scale")
                                    and path[:-6] + "/qw" in q_flat):
            q_bytes += nbytes(leaf)
    for path, leaf in ref_flat.items():
        if path.endswith("/w") and (path[:-2] + "/qw") in q_flat:
            ref_bytes += nbytes(leaf)
    ref_total, q_total = tree_nbytes(ref_params), tree_nbytes(quant_params)
    return {
        "ref_weight_bytes": int(ref_bytes),
        "quant_weight_bytes": int(q_bytes),
        "compression": float(ref_bytes / max(1, q_bytes)),
        "ref_total_bytes": int(ref_total),
        "quant_total_bytes": int(q_total),
        "total_compression": float(ref_total / max(1, q_total)),
    }
