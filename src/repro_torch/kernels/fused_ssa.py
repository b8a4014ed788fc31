"""The SSA bundle: Q/K/V projections with fp32 accumulation -> BN affine
(``bn`` family) or RoPE on q and k (``rope`` family) -> LIF -> binary
attention, causal or not.

Port of ``repro.kernels.fused_ssa``:

* :func:`reference_bundle` — the sequential oracle (the JAX
  ``reference_bundle``), differentiable through the surrogate spikes: the
  fused bundle's backward recomputes through it (``core/engine``);
  binarized scores (binary attention) or, with ``binarize_scores=False``,
  the analog scores ``count * scale`` of Spikformer's SSA (Eq. 2);
* :func:`fused_ssa_plain` — the plain PyTorch version of the kernel:
  the oracle's context (the kernel's rounding, step for step) and the
  ``(H, 4)`` map of executed dots: q, k and v count, per batch row, the
  timesteps whose whole ``(L, D)`` input slab is non-zero (a dark slab
  skips its dot; an analog slab is dark only when it is all zero),
  attend counts ``2 T``;
* :func:`fused_ssa` — the wrapper: CPU tensors take the plain version,
  CUDA tensors launch ``csrc/fused_layer.cu``'s ``fused_ssa_forward``
  (the layer program's launch A alone: the projections, then the
  attention, the spike bits between them in a device scratch) through
  :func:`fused_ssa_cuda` or raise.

Both families run on the kernel, with fp weights or int8 codes cast to
the activation dtype plus ``scale3``: ``bn`` (the vision bundle on
{0,1} spikes) and ``rope`` (the token family's causal bundle on the
ln1-normed currents, RoPE on q and k from a ``(2, L, hd/2)`` [cos; sin]
table). The rope family's three projections are analog sums, exact in
no order: the kernel and the plain version sum them in ascending k, one
fp32 product and one fp32 sum a term (:func:`seq_matmul`, the order
of the layer program's rope family), so the two agree bitwise and
equal the oracle wherever those sums are exact. Analog scores make the
context an analog sum too: every version sums it over the keys in
ascending order, one fp32 add a term (:func:`analog_context`), so the
kernels, their plain versions and ``spike_attention`` agree bitwise.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.spiking import SpikingConfig, lif_scan, spike
from repro_torch.models.nn import bn_affine, fma32, rope_rotate

FAMILIES = ("bn", "rope")
PHASES = ("q", "k", "v", "attend")
# kernel launches on the card, by family and by scores (binarized, or
# analog: ``_analog``): each call of fused_ssa_cuda launches the layer
# program's launch A, two kernels (project_phase, attend_phase), and
# counts both
LAUNCHES = {"fused_ssa": 0, "fused_ssa_rope": 0, "fused_ssa_analog": 0,
            "fused_ssa_rope_analog": 0}
LAUNCHES_PER_CALL = 2


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def binary_scores(q: torch.Tensor, k: torch.Tensor, scale: float,
                  delta, alpha: float = 4.0) -> torch.Tensor:
    """``1[(q k^T) * scale - delta >= 0]`` in fp32. XLA contracts the
    scale and the threshold into one FMA, so the threshold is tested on
    the once-rounded ``fma32(score, scale, -delta)``; scores of {0,1}
    spikes are exact integer counts. Under autograd the step takes the
    sigmoid surrogate of slope ``alpha`` (``core.spiking.spike``)."""
    return threshold_scores(q.float() @ k.float().transpose(-1, -2), scale,
                            delta, alpha)


def threshold_scores(scores: torch.Tensor, scale: float, delta,
                     alpha: float = 4.0) -> torch.Tensor:
    """The threshold of :func:`binary_scores` on fp32 integer counts:
    ``1[fma32(scores, scale, -delta) >= 0]``, surrogate under autograd."""
    neg = -torch.as_tensor(delta, dtype=torch.float32, device=scores.device)
    return spike(fma32(scores, scale, neg), alpha)


def analog_scores(q: torch.Tensor, k: torch.Tensor, scale: float
                  ) -> torch.Tensor:
    """The raw scores of Spikformer's SSA (``binarize_scores=False``):
    the fp32 counts ``q k^T`` (exact integers on {0,1} spikes) times
    ``scale``, rounded once."""
    return (q.float() @ k.float().transpose(-1, -2)) * scale


class _AnalogContext(torch.autograd.Function):
    """:func:`analog_context`'s sum in the forward; the backward of
    ``a @ v`` (the products with the transposes), which the order of the
    forward's sum does not change."""

    @staticmethod
    def forward(ctx, a, v):
        ctx.save_for_backward(a, v)
        acc = torch.zeros((*a.shape[:-1], v.shape[-1]), dtype=torch.float32,
                          device=a.device)
        for j in range(a.shape[-1]):
            acc.add_(a[..., j, None] * v[..., j, None, :])
        return acc

    @staticmethod
    def backward(ctx, g):
        a, v = ctx.saved_tensors
        return g @ v.transpose(-1, -2), a.transpose(-1, -2) @ g


def analog_context(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ v`` for analog scores a (..., Lq, Lk) and {0,1} values
    v (..., Lk, d), summed over the keys in ascending order, one fp32 add
    a term: the CUDA kernels' order (``fused_layer.cu``'s launch A,
    ``spike_attention.cu``). Each term ``a * v`` is exact (v is 0 or 1),
    so this is the sum of the scores of the keys whose value bit is
    set."""
    return _AnalogContext.apply(a.float(), v.float())


def rope_heads(y: torch.Tensor, table: torch.Tensor, num_heads: int
               ) -> torch.Tensor:
    """RoPE on each head of (T, B, L, H*hd) with the (2, L, hd/2)
    [cos; sin] table (``nn.rope_rotate``'s rounding), back in y's dtype."""
    t, b, l, qd = y.shape
    y5 = y.reshape(t, b, l, num_heads, qd // num_heads)
    return rope_rotate(y5, table[0][:, None, :], table[1][:, None, :]
                       ).to(y.dtype).reshape(t, b, l, qd)


def seq_matmul(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ``u @ w`` summed in ascending k, one fp32 product and one fp32
    sum a term: the CUDA kernels' order for the rope family's analog
    products."""
    u32, w32 = u.float(), w.float()
    acc = torch.zeros((*u.shape[:-1], w.shape[-1]), dtype=torch.float32,
                      device=u.device)
    for k in range(u.shape[-1]):
        acc.add_(u32[..., k, None] * w32[k])
    return acc


def _matmul(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return u.float() @ w.float()


def reference_bundle(x: torch.Tensor, w3: torch.Tensor,
                     scale3: Optional[torch.Tensor], aux: torch.Tensor,
                     delta, scfg: SpikingConfig, *, family: str,
                     num_heads: int, head_dim: int, scale: float,
                     causal: bool = False, eps: float = 1e-5,
                     matmul: Callable = _matmul) -> torch.Tensor:
    """x: (T, B, L, D) spikes (bn) or normed currents (rope); w3:
    (3, D, H*hd); aux: (3, 4, H*hd) BN rows [mean, var, scale, bias] (bn)
    or the (2, L, hd/2) [cos; sin] table (rope). Returns the context
    (T, B, L, H*hd). ``matmul`` forms the fp32 projections (the plain
    version passes :func:`seq_matmul`)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown bundle family {family!r}")
    t, b, l, _ = x.shape
    q_dim = num_heads * head_dim
    projected = []
    for j in range(3):
        acc = matmul(x, w3[j])
        if scale3 is not None:
            acc = acc * scale3[j].float()
        y = acc.to(x.dtype)
        if family == "bn":
            y = bn_affine(y.float(), aux[j, 0], torch.rsqrt(aux[j, 1] + eps),
                          aux[j, 2], aux[j, 3]).to(x.dtype)
        elif j < 2:                                  # rope on q, k
            y = rope_heads(y, aux, num_heads)
        projected.append(lif_scan(y, scfg)[0])
    q, k, v = (u.reshape(t * b, l, num_heads, head_dim).transpose(1, 2)
               for u in projected)
    if scfg.binarize_scores:
        attn = binary_scores(q, k, scale, delta, scfg.surrogate_alpha)
    else:
        attn = analog_scores(q, k, scale)
    if causal:
        attn = attn.tril()
    ctx = attn @ v.float() if scfg.binarize_scores \
        else analog_context(attn, v)
    return ctx.to(q.dtype).transpose(1, 2).reshape(t, b, l, q_dim)


def _check_bundle(x, w3, scale3, aux, family, num_heads, head_dim):
    if family not in FAMILIES:
        raise ValueError(f"unknown fused-SSA family {family!r} "
                         f"(expected bn|rope)")
    t, b, l, d = x.shape
    q_dim = num_heads * head_dim
    if family == "rope" and head_dim % 2:
        raise ValueError("the rope family takes an even head_dim")
    aux_shape = (3, 4, q_dim) if family == "bn" else (2, l, head_dim // 2)
    want = {"w3": (w3.shape, (3, d, q_dim)), "aux": (aux.shape, aux_shape)}
    if scale3 is not None:
        want["scale3"] = (scale3.shape, (3, q_dim))
    for name, (got, shape) in want.items():
        if tuple(got) != shape:
            raise ValueError(f"{name} has shape {tuple(got)}, expected "
                             f"{shape}")


def bundle_counts(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The kernel's ``(H, 4)`` int32 map of executed dots: q, k, v count
    the (b, t) whose ``(L, D)`` slab holds a non-zero entry, the attend
    phase ``2 T`` a batch row; every head counts the same."""
    t, b = x.shape[:2]
    live = int((x != 0).reshape(t, b, -1).any(dim=2).sum())
    row = torch.tensor([live, live, live, 2 * t * b], dtype=torch.int32,
                       device=x.device)
    return row.expand(num_heads, 4).contiguous()


def _spiking_config(decay: float, v_th: float, soft_reset: bool,
                binarize_scores: bool = True) -> SpikingConfig:
    scfg = SpikingConfig(tau=1.0 / (1.0 - decay), v_threshold=v_th,
                         soft_reset=soft_reset,
                         binarize_scores=binarize_scores)
    if scfg.decay != decay:
        raise ValueError(f"decay {decay!r} is not 1 - 1/tau of a float tau")
    return scfg


def fused_ssa_plain(x: torch.Tensor, w3: torch.Tensor,
                    scale3: Optional[torch.Tensor], aux: torch.Tensor, delta,
                    *, num_heads: int, head_dim: int, scale: float,
                    family: str = "bn", causal: bool = False,
                    binarize_scores: bool = True, decay: float = 0.5,
                    v_th: float = 1.0, soft_reset: bool = False,
                    eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, with the launcher's signature:
    (context (T, B, L, H*hd) in the activation dtype, counts (H, 4)
    int32). Skipped dots add exact zeros, so the context is
    :func:`reference_bundle`'s, which rounds as the kernel does: fp32
    sums, ``* scale3`` and the cast, BN as ``fma32((y - mean) *
    rsqrt(var + eps), scale, bias)`` (bn) or ``nn.rope_rotate`` on q and
    k (rope), LIF in the activation dtype, the threshold ``fma32(count,
    scale, -delta)`` (or the analog scores ``fl(count * scale)`` summed
    over the keys in ascending order, :func:`analog_context`); the rope
    family's analog projections are summed in the kernel's order
    (ascending k), which is the oracle's value wherever those sums are
    exact."""
    ctx = reference_bundle(x, w3, scale3, aux, delta,
                           _spiking_config(decay, v_th, soft_reset,
                                       binarize_scores),
                           family=family, num_heads=num_heads,
                           head_dim=head_dim, scale=scale, causal=causal,
                           eps=eps,
                           matmul=seq_matmul if family == "rope" else _matmul)
    return ctx, bundle_counts(x, num_heads)


def fused_ssa(x: torch.Tensor, w3: torch.Tensor,
              scale3: Optional[torch.Tensor], aux: torch.Tensor, delta, *,
              family: str, num_heads: int, head_dim: int, scale: float,
              causal: bool = False, binarize_scores: bool = True,
              decay: float = 0.5, v_th: float = 1.0,
              soft_reset: bool = False, eps: float = 1e-5
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused projection + attention SSA step (forward only; the engine's
    ``_FusedBundle`` gives it the oracle's backward), the signature of the
    JAX ``fused_ssa``. x: (T, B, L, D) {0,1} spikes (bn) or normed
    currents (rope) in the activation dtype; w3: (3, D, H*hd) in that
    dtype (int8 codes cast to it); scale3: (3, H*hd) fp32 or None; aux:
    (3, 4, H*hd) BN rows [mean, var, scale, bias] (bn) or the (2, L,
    hd/2) fp32 [cos; sin] table (rope); causal: mask future keys. Returns
    (context (T, B, L, H*hd), counts (H, 4) int32 — executed dots per
    head and phase, :data:`PHASES`). ``binarize_scores=False``: the
    analog scores of Spikformer's SSA; the counts are the same."""
    _check_bundle(x, w3, scale3, aux, family, num_heads, head_dim)
    kw = dict(num_heads=num_heads, head_dim=head_dim, scale=scale,
              family=family, causal=causal, binarize_scores=binarize_scores,
              decay=decay, v_th=v_th, soft_reset=soft_reset, eps=eps)
    if x.device.type == "cpu":
        return fused_ssa_plain(x, w3, scale3, aux, delta, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ssa runs on CPU or CUDA tensors, not "
                         f"{x.device.type}")
    return fused_ssa_cuda(x, w3, scale3, aux, delta, **kw)


def _library():
    from repro_torch.kernels import fused_layer
    lib = fused_layer._library()
    if lib.fused_ssa_forward.argtypes is None:
        lib.fused_ssa_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_float] * 3
            + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 4)
        lib.fused_ssa_forward.restype = ctypes.c_int
    return lib


def fused_ssa_cuda(x: torch.Tensor, w3: torch.Tensor,
                   scale3: Optional[torch.Tensor], aux: torch.Tensor, delta,
                   *, num_heads: int, head_dim: int, scale: float,
                   family: str = "bn", causal: bool = False,
                   binarize_scores: bool = True, decay: float = 0.5,
                   v_th: float = 1.0, soft_reset: bool = False,
                   eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the bundle's two kernels on PyTorch's current stream,
    counted (2 a call) under ``fused_ssa`` (bn) or ``fused_ssa_rope``,
    with ``_analog`` appended for analog scores (the kernel's analog
    instantiation). x and w3 share one dtype (float32 or bfloat16),
    which the context takes; BN rows are passed
    with the inverse std, ``torch.rsqrt(var + eps)`` computed once per
    channel (the oracle's); the rope table as fp32."""
    from repro_torch.kernels import fused_layer as FL
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    if x.dtype not in dtypes or w3.dtype != x.dtype:
        raise ValueError(f"fused_ssa kernel takes x and w3 of one dtype, "
                         f"float32 or bfloat16, got {x.dtype} and {w3.dtype}")
    t, b, l, d = x.shape
    q_dim = num_heads * head_dim
    dev = x.device
    rope = family == "rope"
    if scale3 is None:
        scale3 = torch.ones((3, q_dim), dtype=torch.float32, device=dev)
    aux = aux.float() if rope else FL._inv_rows(aux, eps)
    f32 = (scale3.float().contiguous(), aux.contiguous(),
           torch.as_tensor(delta, dtype=torch.float32, device=dev
                           ).reshape(1).contiguous())
    act = (x.contiguous(), w3.contiguous())
    for a in act + f32:
        if a.device != dev:
            raise ValueError("all fused_ssa operands must be on one device")
    FL.check_launch_shapes(x.element_size(), t, l, d, num_heads, head_dim, 1,
                           rope=rope, what="fused_ssa")
    ctx = torch.empty((t, b, l, q_dim), dtype=x.dtype, device=dev)
    counts = torch.zeros((num_heads, 4), dtype=torch.int32, device=dev)
    if ctx.numel() == 0:
        return ctx, counts
    # launch A's spike bits and count flags (one L-block a sequence)
    bits = torch.zeros(FL.bits_words(t, b, l, num_heads, head_dim, 1),
                       dtype=torch.int32, device=dev)
    cw = FL.column_width(x.element_size(), d, num_heads, head_dim, rope,
                         "fused_ssa")
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_ssa_forward(
        dtypes[x.dtype], *(a.data_ptr() for a in act + f32), float(scale),
        float(decay), float(v_th), int(soft_reset), int(rope), int(causal),
        int(not binarize_scores), t, b, l, d, num_heads, head_dim, cw,
        bits.data_ptr(), ctx.data_ptr(), counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_ssa kernel launch failed: "
                           f"{lib.fused_layer_error(rc).decode()}")
    name = "fused_ssa_rope" if rope else "fused_ssa"
    LAUNCHES[name + ("" if binarize_scores else "_analog")] += \
        LAUNCHES_PER_CALL
    return ctx, counts
