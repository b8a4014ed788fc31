"""Dual-engine dispatch: per-matmul and per-attention engine selection,
and the layer program (the subset the vision family's eval and train
paths and the token family's spiking LM need).

Mirrors ``repro.core.engine``: ``EngineConfig`` and its validation, the
ambient engine (``use_engine`` / ``engine_scope``), the dispatch rules,
``spike_linear`` (dense, or the sparse engine's tile kernel
``spike_matmul`` or decoded kernel ``gather_spike_matmul``, with the
dense-transpose backward of the JAX custom VJP), ``dense_quant_linear``
(the quantized dense reference), the sequential branches of ``ssa_step``
and ``ssa_step_causal``, and the two layer programs: ``layer_step``
(vision, ``bn`` epilogues) and ``layer_step_causal`` (token family,
RoPE / rmsnorm epilogues, causal). An eligible eval layer goes either to
the sequential oracle (``overlap='off'``) or to the layer program
(``kernels/fused_layer``: ``overlap='fused'``, or ``'pipeline'`` for the
TPU kernel's timestep wavefront, one timestep at a time with the
membranes carried across T; the same outputs); train mode and
ineligible layers take the sequential composition.

The port's 'auto' rules for ``mode``, ``binary`` and ``overlap`` read
the device, not JAX's flop floor: on a CUDA tensor 'auto' always picks
the kernel, whose wrapper launches it or raises; on the CPU it picks the
plain path, as JAX does for small shapes and under jit. 'auto' never
picks ``overlap='pipeline'``, as in JAX. ``sparse='auto'``
follows JAX's rule for concrete inputs on every device, since a PyTorch
tensor is always concrete: it reads the occupancy histogram
(``kernels/spike_decode.choose_sparse_path``) and counts each decision in
:data:`SPARSE_DECISIONS`.

Quantized spike products on the sparse path run the int8 kernels
(``quant_spike_matmul`` on the tile path, ``quant_gather_spike_matmul``
on the decoded path) with the dequantized backward of JAX's
``_quant_sparse_bwd``; an eligible eval SSA bundle under
``overlap='fused'`` or ``'pipeline'`` runs the bundle kernel
``fused_ssa`` (bn family in
``ssa_step``, rope family in ``ssa_step_causal``), whose backward
recomputes through the oracle, as JAX's ``_fused_bwd`` does. A
mixed-precision layer (some linears quantized) takes the sequential
composition and so reaches them. The layer program under
``overlap='fused'`` or ``'pipeline'`` runs behind ``_FusedLayer``, whose
backward recomputes ``reference_layer``, as JAX's ``_fused_layer`` VJP
does, so the gradients under every overlap mode are the oracle's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core.spiking import lif_scan

SPARSE_PATHS = ("tile", "decoded")
OVERLAP_MODES = ("off", "fused", "pipeline")
ENGINE_MODES = ("dense", "sparse")
BINARY_MODES = ("jnp", "mxu_kernel", "popcount")
WEIGHT_DATAPATHS = ("fp32", "int8", "int4")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Dual-engine dispatch knobs (per model, set on ModelConfig.engine):
    the fields of ``repro.core.engine.EngineConfig`` that the port reads,
    with the same defaults and meaning.

    mode: 'dense' | 'sparse' | 'auto' — spike x weight products through
      the dense product or the sparse engine's kernel (``spike_matmul``
      or ``gather_spike_matmul``, as ``sparse`` resolves);
    binary: 'jnp' | 'mxu_kernel' | 'popcount' | 'auto' — spiking
      attention through the plain oracle, the ``spike_attention``
      kernel, or the bit-packed ``popcount_scores`` kernel (then the
      threshold and the context product in plain PyTorch);
    sparse: 'tile' | 'decoded' | 'auto' — the sparse datapath: the tile
      skip, the decoded gather, or per call from the occupancy histogram
      (:func:`resolve_sparse_path`);
    block_m: the row group of the decoded schedule and of the tile
      fraction 'auto' reads, and the L-block of the layer program's
      occupancy skips;
    block_k: the decoded path's compacted chunk (``c_block``) and the
      tile width 'auto' reads — it decides the decoded capacities and the
      executed-chunk counts, so it is kept;
    overlap: 'off' | 'fused' | 'pipeline' | 'auto' — the layer program;
    packed_kv: spiking decode caches store K/V bit-packed (32-bit words)
      and score against them with AND-popcount;
    weights: the declared weight datapath, 'fp32' | 'int8' | 'int4'
      (``launch/serve.py --quantize`` sets it); :func:`spike_linear`
      checks that it is handed such codes.

    JAX's ``min_flops`` is left out: the port's 'auto' does not read it
    (see :func:`resolve_mode`). So are the TPU kernels' other VMEM tile
    sizes (``block_n``, ``attn_block_q``, ``attn_block_k``): the CUDA
    kernels choose their own tiles, and the values they compute do not
    depend on them."""
    mode: str = "auto"
    sparse: str = "tile"
    block_m: int = 128
    block_k: int = 128
    binary: str = "auto"
    packed_kv: bool = True
    overlap: str = "off"
    weights: str = "fp32"

    def __post_init__(self):
        if self.weights not in WEIGHT_DATAPATHS:
            raise ValueError(f"unknown weights datapath {self.weights!r} "
                             f"(expected fp32|int8|int4)")
        if self.mode not in ENGINE_MODES + ("auto",):
            raise ValueError(f"unknown engine mode {self.mode!r} "
                             f"(expected dense|sparse|auto)")
        if self.binary not in BINARY_MODES + ("auto",):
            raise ValueError(f"unknown binary engine mode {self.binary!r} "
                             f"(expected jnp|mxu_kernel|popcount|auto)")
        if self.sparse not in SPARSE_PATHS + ("auto",):
            raise ValueError(f"unknown sparse datapath {self.sparse!r} "
                             f"(expected tile|decoded|auto)")
        if self.overlap not in OVERLAP_MODES + ("auto",):
            raise ValueError(f"unknown overlap mode {self.overlap!r} "
                             f"(expected off|fused|pipeline|auto)")
        for name in ("block_m", "block_k"):
            if not isinstance(getattr(self, name), int) or \
                    getattr(self, name) < 1:
                raise ValueError(f"{name} must be a positive int, got "
                                 f"{getattr(self, name)!r}")

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


_state = threading.local()


def get_engine() -> Optional[EngineConfig]:
    return getattr(_state, "engine", None)


class use_engine:
    """Context manager installing the ambient engine; ``use_engine(None)``
    disables dispatch."""

    def __init__(self, engine: Optional[EngineConfig]):
        self.engine = engine

    def __enter__(self):
        self.prev = get_engine()
        _state.engine = self.engine
        return self.engine

    def __exit__(self, *exc):
        _state.engine = self.prev


def engine_scope(cfg) -> contextlib.AbstractContextManager:
    """Installs ``cfg.engine`` when the config sets one, otherwise leaves
    the ambient engine untouched."""
    engine = getattr(cfg, "engine", None)
    if engine is None:
        return contextlib.nullcontext()
    return use_engine(engine)


def _on_cuda(x) -> bool:
    return x is not None and x.device.type == "cuda"


def resolve_mode(engine: Optional[EngineConfig], x=None) -> str:
    """Dense-vs-sparse decision for a spike x weight product on ``x``.

    'auto' picks the ``spike_matmul`` kernel for every CUDA tensor,
    whatever its size (the wrapper launches it or raises), and the dense
    product on the CPU; explicit values are honoured everywhere."""
    if engine is None:
        return "dense"
    if engine.mode in ENGINE_MODES:
        return engine.mode
    return "sparse" if _on_cuda(x) else "dense"


def resolve_binary_mode(engine: Optional[EngineConfig], x=None) -> str:
    """Binary-engine decision for a spiking attention on ``x``: 'auto'
    picks the ``spike_attention`` kernel ('mxu_kernel') for every CUDA
    tensor and the plain oracle ('jnp') on the CPU, and never 'popcount',
    as in JAX; explicit values are honoured everywhere."""
    if engine is None:
        return "jnp"
    if engine.binary in BINARY_MODES:
        return engine.binary
    return "mxu_kernel" if _on_cuda(x) else "jnp"


# 'auto' decisions of resolve_sparse_path since the last reset, by path
SPARSE_DECISIONS = {"tile": 0, "decoded": 0}


def reset_sparse_decisions() -> None:
    for path in SPARSE_DECISIONS:
        SPARSE_DECISIONS[path] = 0


def resolve_sparse_path(engine: Optional[EngineConfig], x=None) -> str:
    """Tile-vs-decoded decision for the sparse datapath on spikes ``x``
    (any shape; the last dim is K).

    Explicit 'tile' and 'decoded' are honoured everywhere. 'auto' takes
    JAX's rule for concrete spikes on every device (a PyTorch tensor is
    always concrete): ``choose_sparse_path`` on ``x`` reshaped to (-1, K)
    with the engine's ``block_m`` and ``block_k``; without spikes it
    resolves 'tile'. Each 'auto' decision reads two fractions back from
    the device (one synchronisation on the card) and is counted in
    :data:`SPARSE_DECISIONS`."""
    if engine is None:
        return "tile"
    if engine.sparse in SPARSE_PATHS:
        return engine.sparse
    if x is None:
        return "tile"
    from repro_torch.kernels.spike_decode import choose_sparse_path
    path = choose_sparse_path(x.reshape(-1, x.shape[-1]), engine.block_m,
                              engine.block_k)
    SPARSE_DECISIONS[path] += 1
    return path


def resolve_overlap(engine: Optional[EngineConfig], x=None) -> str:
    """Fused-vs-sequential decision for a layer step.

    JAX fuses under 'auto' when the input is concrete, off the TPU, and
    the flops reach ``min_flops``; the flop floor keeps small layers out
    of interpret mode. A PyTorch tensor is always concrete, and the fused
    kernel's home is now the card, where it is built and checked against
    its plain version and has no interpret mode. So 'auto' fuses whenever
    ``x`` lies on a CUDA device, whatever the layer's size, and the
    wrapper there launches the kernel or raises; on the CPU 'auto' stays
    'off' and takes the oracle, as JAX does under jit. Explicit 'fused'
    and 'pipeline' are honoured everywhere; 'auto' never picks 'pipeline',
    as in JAX."""
    if engine is None:
        return "off"
    if engine.overlap in OVERLAP_MODES:
        return engine.overlap
    return "fused" if _on_cuda(x) else "off"


class LayerPlan(NamedTuple):
    """The static execution plan of a whole-layer step."""
    overlap: str
    sparse: str


def resolve_layer_plan(engine: Optional[EngineConfig], x=None) -> LayerPlan:
    """One plan for a whole-layer step: the overlap grid and the sparse
    datapath of its projections, decided on the layer's input spikes."""
    return LayerPlan(resolve_overlap(engine, x),
                     resolve_sparse_path(engine, x))


def dense_spike_linear(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The dense reference: fp32-accumulated product + bias, cast back to
    the activation dtype — term for term what the sparse kernel computes."""
    y = x.float() @ p["w"].float()
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def _unpacked_qw(p: Dict[str, Any], k: int) -> torch.Tensor:
    """int8 weight codes of a quantized param dict (int4 nibbles are
    unpacked here; storage stays packed)."""
    qw = p["qw"]
    if qw.dtype == torch.uint8:
        from repro_torch.quant.quantize import unpack_int4
        qw = unpack_int4(qw, k)
    return qw


def dense_quant_linear(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The quantized dense reference: fp32-accumulated product against the
    int codes cast to the activation dtype, the per-output-channel scale
    (+ bias, as one fused multiply-add, the jitted reference's rounding)
    in the epilogue, cast back to the activation dtype. On analog inputs
    this is weight-only quantized compute (``nn.linear_acc`` then
    ``nn.linear_epilogue``, the split a mesh's row-split product sums
    between)."""
    from repro_torch.models.nn import linear_acc, linear_epilogue
    return linear_epilogue(p, linear_acc(p, x), x.dtype)


class _SparseMatmul(torch.autograd.Function):
    """The sparse engine's kernel forward — ``spike_matmul`` on the tile
    path, ``gather_spike_matmul`` on the decoded path — its fp32
    accumulator rounded once to the activation dtype in the kernel's
    store, with the dense-transpose backward of
    ``repro.core.engine._sparse_bwd``, the same for both paths (the
    cotangent of that rounding is the upcast ``g``, as in JAX)."""

    @staticmethod
    def forward(ctx, s2d, w, b, path, block_m, block_k, analog=False):
        ctx.save_for_backward(s2d, w, b)
        if path == "decoded":
            # sums in ascending k on any values: no analog mode of its own
            from repro_torch.kernels.spike_decode import gather_spike_matmul
            return gather_spike_matmul(s2d, w, b, block_m=block_m,
                                       c_block=block_k)
        from repro_torch.kernels.spike_matmul import spike_matmul
        return spike_matmul(s2d, w, b, analog=analog)

    @staticmethod
    def backward(ctx, g):
        s2d, w, b = ctx.saved_tensors
        g32 = g.float()
        ds = (g32 @ w.float().t()).to(s2d.dtype)
        dw = (s2d.float().t() @ g32).to(w.dtype)
        db = None if b is None else g32.sum(dim=0).to(b.dtype)
        return ds, dw, db, None, None, None, None


class _QuantSparseMatmul(torch.autograd.Function):
    """The quantized sparse kernel forward — ``quant_spike_matmul`` on the
    tile path, ``quant_gather_spike_matmul`` on the decoded path — its
    fp32 epilogue rounded once to ``out_dtype`` in the kernel's store,
    with the backward of ``repro.core.engine._quant_sparse_bwd``: ``ds``
    through the dequantized weights, ``dscale = sum(g * acc)``, ``db =
    sum(g)``, none for the integer codes."""

    @staticmethod
    def forward(ctx, s2d, qw, scale, b, path, block_m, block_k, counts,
                out_dtype):
        ctx.save_for_backward(s2d, qw, scale, b)
        kw = dict(counts=counts, out_dtype=out_dtype)
        if path == "decoded":
            from repro_torch.kernels.spike_decode import \
                quant_gather_spike_matmul
            return quant_gather_spike_matmul(s2d, qw, scale, b,
                                             block_m=block_m,
                                             c_block=block_k, **kw)
        from repro_torch.kernels.spike_matmul import quant_spike_matmul
        return quant_spike_matmul(s2d, qw, scale, b, **kw)

    @staticmethod
    def backward(ctx, g):
        s2d, qw, scale, b = ctx.saved_tensors
        g32 = g.float()
        w_deq = qw.float() * scale[None, :]
        ds = (g32 @ w_deq.t()).to(s2d.dtype)
        acc = s2d.float() @ qw.float()
        dscale = (g32 * acc).sum(dim=0).to(scale.dtype)
        db = None if b is None else g32.sum(dim=0).to(b.dtype)
        return ds, None, dscale, db, None, None, None, None, None


def spike_linear(p: Dict[str, Any], x: torch.Tensor, *,
                 engine: Optional[EngineConfig] = None,
                 counts: bool = False, analog: bool = False) -> torch.Tensor:
    """Dual-engine linear layer for spike inputs ({0,1} spikes, or with
    ``counts=True`` the integer counts of a binary-attention context,
    which only the quantized datapath treats differently; ``analog=True``:
    the analog context of a ``binarize_scores=False`` layer, which the
    tile path sums in ascending k, ``spike_matmul``'s analog mode). Leading
    dims fold into the sparse engine's M; the fp32 accumulator is rounded
    once to ``x.dtype`` (JAX's cast, fused into the kernel's store).
    ``engine=None`` uses the ambient engine; no engine means dense."""
    engine = engine if engine is not None else get_engine()
    quantized = "qw" in p
    if engine is not None and engine.weights != "fp32":
        # the declared datapath is a contract: a config serving int8 must
        # be handed int8 codes (an int4 declaration accepts int8-stored
        # codes too, which the int4 quantizer keeps for odd K)
        if not (quantized and (engine.weights == "int4"
                               or p["qw"].dtype == torch.int8)):
            actual = "fp32 (unquantized)" if not quantized \
                else "packed int4"
            raise ValueError(
                f"engine declares weights={engine.weights!r} but this "
                f"linear's params are {actual} (quantize_tree the params "
                f"or fix EngineConfig.weights)")
    if resolve_mode(engine, x) == "dense":
        return dense_quant_linear(p, x) if quantized \
            else dense_spike_linear(p, x)
    k = x.shape[-1]
    x2d = x.reshape(-1, k)
    path = resolve_sparse_path(engine, x2d)
    if quantized:
        # JAX's operands: fp32 activations (the kernel casts them to its
        # int8 or, with counts, int32 lanes), int8 codes, fp32 scale; the
        # fp32 epilogue is cast to x.dtype once, in the kernel's store
        out = _QuantSparseMatmul.apply(
            x2d.float(), _unpacked_qw(p, k), p["scale"].float(), p.get("b"),
            path, engine.block_m, engine.block_k, counts, x.dtype)
    else:
        out = _SparseMatmul.apply(x2d, p["w"], p.get("b"), path,
                                  engine.block_m, engine.block_k, analog)
    return out.reshape(*x.shape[:-1], out.shape[-1])


class BundleSpec(NamedTuple):
    """The static closure of a fused SSA step (JAX's ``_BundleSpec``),
    shared by the kernel forward and the oracle backward."""
    family: str
    num_heads: int
    head_dim: int
    scale: float
    causal: bool
    scfg: Any                   # SpikingConfig
    eps: float


def _recompute_grads(fn, saved, g):
    """The oracle backward of a fused step: ``fn`` recomputed on fresh
    leaves of the saved operands and differentiated against ``g``; None
    for operands that take no gradient (integer codes, None)."""
    leaves = [None if t is None else t.detach().requires_grad_(
        t.is_floating_point()) for t in saved]
    with torch.enable_grad():
        out = fn(*leaves)
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)


class _FusedBundle(torch.autograd.Function):
    """The bundle kernel forward (``kernels/fused_ssa.fused_ssa``, either
    family; the plain version on the CPU), with JAX's ``_fused_bwd``:
    the backward recomputes ``reference_bundle`` and differentiates it, so
    its gradients are the sequential path's (surrogate spikes included).
    Quantized codes are cast to the activation dtype before this
    boundary, so their gradient stops at that cast."""

    @staticmethod
    def forward(ctx, x, w3, scale3, aux, delta, spec):
        from repro_torch.kernels.fused_ssa import fused_ssa
        ctx.save_for_backward(x, w3, scale3, aux, delta)
        ctx.spec = spec
        scfg = spec.scfg
        out, _ = fused_ssa(x, w3, scale3, aux, delta, family=spec.family,
                           num_heads=spec.num_heads, head_dim=spec.head_dim,
                           scale=spec.scale, causal=spec.causal,
                           binarize_scores=scfg.binarize_scores,
                           decay=scfg.decay, v_th=scfg.v_threshold,
                           soft_reset=scfg.soft_reset, eps=spec.eps)
        return out

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.fused_ssa import reference_bundle
        spec = ctx.spec

        def oracle(x, w3, scale3, aux, delta):
            return reference_bundle(x, w3, scale3, aux, delta, spec.scfg,
                                    family=spec.family,
                                    num_heads=spec.num_heads,
                                    head_dim=spec.head_dim, scale=spec.scale,
                                    causal=spec.causal, eps=spec.eps)
        return (*_recompute_grads(oracle, ctx.saved_tensors, g), None)


class LayerSpec(NamedTuple):
    """The static closure of a layer-program step (JAX's ``_LayerSpec``),
    shared by the kernel forward and the oracle backward."""
    family: str
    num_heads: int
    head_dim: int
    scale: float
    causal: bool
    scfg: Any                   # SpikingConfig
    eps: float
    norm_eps: float
    sparse: str                 # tile | decoded
    l_block: int
    c_block: int
    overlap: str                # fused | pipeline


class _FusedLayer(torch.autograd.Function):
    """The layer program's forward (``kernels/fused_layer.fused_layer``:
    the CUDA kernel on the card, the plain version on the CPU), with the
    backward of JAX's ``_fused_layer`` custom VJP: it recomputes
    ``reference_layer`` on the saved operands and differentiates it, so
    the gradients are the sequential oracle's (surrogate spikes
    included). The kernel writes fresh tensors and takes no part in
    autograd; without this boundary its callers' parameters would get no
    gradient. Operands: x, s, w3, wo, w1, w2, the four scales, auxp,
    auxo, aux1, aux2 (None for rope), delta; quantized codes are cast to
    the activation dtype before it, so their gradient stops at that
    cast."""

    @staticmethod
    def forward(ctx, *ops):
        from repro_torch.kernels.fused_layer import fused_layer
        *ops, spec = ops
        ctx.save_for_backward(*ops)
        ctx.spec = spec
        scfg = spec.scfg
        out, _ = fused_layer(
            *ops[:6], tuple(ops[6:10]), *ops[10:], family=spec.family,
            num_heads=spec.num_heads, head_dim=spec.head_dim,
            scale=spec.scale, causal=spec.causal, sparse=spec.sparse,
            pipeline=spec.overlap == "pipeline",
            binarize_scores=scfg.binarize_scores, decay=scfg.decay,
            v_th=scfg.v_threshold, soft_reset=scfg.soft_reset, eps=spec.eps,
            norm_eps=spec.norm_eps, l_block=spec.l_block,
            c_block=spec.c_block)
        return out

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.fused_layer import reference_layer
        spec = ctx.spec

        def oracle(*ops):
            return reference_layer(
                *ops[:6], tuple(ops[6:10]), *ops[10:], spec.scfg,
                family=spec.family, num_heads=spec.num_heads,
                head_dim=spec.head_dim, scale=spec.scale, causal=spec.causal,
                eps=spec.eps, norm_eps=spec.norm_eps)
        return (*_recompute_grads(oracle, ctx.saved_tensors, g), None)


def _layer_program(args, scfg, plan: LayerPlan, engine: EngineConfig, *,
                   family: str, num_heads: int, head_dim: int, scale: float,
                   causal: bool = False, eps: float = 1e-5,
                   norm_eps: float = 1e-6) -> torch.Tensor:
    """One eligible layer on the plan's overlap: ``reference_layer``
    (``overlap='off'``) or the layer program through :class:`_FusedLayer`
    (``overlap='fused'`` or ``'pipeline'``). ``args`` are
    ``reference_layer``'s operands, the scales as one tuple and delta a
    tensor (the layer's param)."""
    from repro_torch.kernels.fused_layer import reference_layer
    kw = dict(family=family, num_heads=num_heads, head_dim=head_dim,
              scale=scale, causal=causal, eps=eps, norm_eps=norm_eps)
    if plan.overlap == "off":
        return reference_layer(*args, scfg, **kw)
    *ops, scales, auxp, auxo, aux1, aux2, delta = args
    spec = LayerSpec(scfg=scfg, sparse=plan.sparse, l_block=engine.block_m,
                     c_block=engine.block_k, overlap=plan.overlap, **kw)
    return _FusedLayer.apply(*ops, *scales, auxp, auxo, aux1, aux2, delta,
                             spec)


def _launch_a_takes(x: torch.Tensor, d: int, heads: int, head_dim: int,
                    rope: bool = False) -> bool:
    """Whether launch A of the layer program and the bundle kernel takes
    a layer of these widths (``kernels/fused_layer.launch_a_takes``). Asked
    on every device, so a layer it does not take (head_dim above 128, a D
    too wide for a w3 column slice) takes the sequential composition, whose
    binary attention takes any head_dim, on the CPU as on the card."""
    from repro_torch.kernels.fused_layer import launch_a_takes
    return launch_a_takes(x.element_size(), d, heads, head_dim, rope=rope)


def ssa_step(p: Dict[str, Any], st: Dict[str, Any], cfg, s: torch.Tensor, *,
             train: bool = False, engine: Optional[EngineConfig] = None):
    """The vision-family SSA bundle: Q/K/V projections (+ BatchNorm +
    LIF) and binary attention. s: (T, B, L, D) {0,1} spikes; st: the
    bn_q/bn_k/bn_v running stats. Returns (ctx (T, B, L, q_dim), new BN
    state).

    Eligible eval bundles (bias-free q/k/v, all or none quantized) under
    ``overlap='fused'`` or ``'pipeline'`` (as in JAX) run the bundle kernel ``fused_ssa`` (the plain
    version on the CPU) on the stacked weights — int8 codes cast to the
    activation dtype with their (3, q_dim) scales — and the (3, 4, q_dim)
    BN rows, and return the state unchanged; everything else runs the
    sequential composition below (train mode always, and a bundle whose
    widths the kernel does not take, :func:`_launch_a_takes`)."""
    from repro_torch.core.attention import spiking_attention
    from repro_torch.models import nn
    engine = engine if engine is not None else get_engine()
    t, b, l, d = s.shape
    heads, hd = cfg.num_heads, cfg.head_dim
    names = (("q", "wq"), ("k", "wk"), ("v", "wv"))
    quant = ["qw" in p[w] for _, w in names]
    eligible = (not train and (all(quant) or not any(quant))
                and not any("b" in p[w] for _, w in names)
                and _launch_a_takes(s, d, heads, hd))
    if eligible and resolve_overlap(engine, s) in ("fused", "pipeline"):
        if all(quant):
            w3, scale3 = _layer_quant_w3(p, [w for _, w in names], d,
                                         s.dtype)
        else:
            w3 = torch.stack([p[w]["w"] for _, w in names])
            scale3 = None
        aux = torch.stack([_bn_rows(p, st, f"bn_{n}") for n, _ in names])
        spec = BundleSpec("bn", heads, hd, 1.0 / math.sqrt(hd), False,
                          cfg.spiking, 1e-5)
        delta = torch.as_tensor(p["delta"], dtype=torch.float32,
                                device=s.device)
        return _FusedBundle.apply(s, w3, scale3, aux, delta, spec), dict(st)
    new_st = dict(st)

    def proj(name, w):
        cur = nn.linear(p[w], s, spikes=True)
        y, new_st[f"bn_{name}"] = nn.batchnorm(
            p[f"bn_{name}"], st[f"bn_{name}"],
            cur.reshape(-1, cur.shape[-1]), train=train)
        return lif_scan(y.reshape(cur.shape), cfg.spiking)[0]

    # (T,B,L,q_dim) -> (T*B, H, L, hd) for the binary-attention primitive
    fold = lambda u: u.reshape(t * b, l, heads, hd).transpose(1, 2)
    q_s, k_s, v_s = (fold(proj(n, w)) for n, w in names)
    ctx = spiking_attention(q_s, k_s, v_s, cfg.spiking,
                            delta_score=p["delta"])
    return ctx.transpose(1, 2).reshape(t, b, l, cfg.q_dim), new_st


def _layer_quant_w3(p, names, d: int, dtype: torch.dtype):
    """(stacked q/k/v codes in the activation dtype, (3, q_dim) scales)
    for an all-quantized layer."""
    w3 = torch.stack([_unpacked_qw(p[w], d) for w in names]).to(dtype)
    sc3 = torch.stack([p[w]["scale"].float() for w in names])
    return w3, sc3


def _layer_linear(p: Dict[str, Any], k: int, dtype: torch.dtype):
    """(weight codes or weights in the activation dtype, fp32 scale or
    ones) for one layer linear, quantized or native."""
    if "qw" in p:
        return _unpacked_qw(p, k).to(dtype), p["scale"].float()
    w = p["w"]
    return w.to(dtype), torch.ones(w.shape[-1], dtype=torch.float32,
                                   device=w.device)


def _pad_ff(w1, w2, sc1, aux1, heads: int):
    """Zero-pad d_ff to a multiple of ``num_heads`` (each head owns one
    ff-chunk). Exact: padded channels carry zero current through identity
    BN rows ([mean 0, var 1, scale 1, bias 0]), never spike, and meet
    zero down-rows."""
    ff = w1.shape[1]
    pad = (-ff) % heads
    if pad == 0:
        return w1, w2, sc1, aux1
    w1 = torch.nn.functional.pad(w1, (0, pad))
    w2 = torch.nn.functional.pad(w2, (0, 0, 0, pad))
    sc1 = torch.nn.functional.pad(sc1, (0, pad), value=1.0)
    if aux1 is not None:
        ident = torch.tensor([0.0, 1.0, 1.0, 0.0], dtype=torch.float32,
                             device=aux1.device)[:, None].expand(4, pad)
        aux1 = torch.cat([aux1, ident], dim=1)
    return w1, w2, sc1, aux1


def _bn_rows(p, st, name):
    return torch.stack([st[name]["mean"].float(), st[name]["var"].float(),
                        p[name]["scale"].float(), p[name]["bias"].float()])


def layer_step(p: Dict[str, Any], st: Dict[str, Any], cfg, x: torch.Tensor,
               *, train: bool = False,
               engine: Optional[EngineConfig] = None):
    """The vision-family layer program: input LIF + SSA bundle + wo/bn_o
    + pre-neuron residual + spiking MLP + residual, as one engine-owned
    step. x: (T, B, L, D) membrane currents. Returns (y, new BN state).

    An eligible eval layer runs the sequential oracle ``reference_layer``
    (``overlap='off'``) or the layer program ``fused_layer``
    (``overlap='fused'``, or ``'pipeline'`` timestep by timestep; the CUDA
    kernel for CUDA tensors), whose q/k/v
    projections take the plan's sparse datapath (the L-block tile skip,
    or the decoded gather with ``c_block = block_k`` and ``l_block =
    block_m``, as in JAX). Train mode
    (batch statistics) and ineligible layers (JAX's terms, and widths
    that launch A does not take: :func:`_launch_a_takes`) run the
    sequential composition, which hands the SSA bundle to :func:`ssa_step` and the
    spike products to :func:`spike_linear`, threading the BN state."""
    engine = engine if engine is not None else get_engine()
    heads, hd = cfg.num_heads, cfg.head_dim
    d = x.shape[-1]
    lin_names = ("wq", "wk", "wv", "wo", "w1", "w2")
    quant = ["qw" in p[w] for w in lin_names]
    eligible = (not train
                and (all(quant) or not any(quant))
                and not any("b" in p[w] for w in lin_names)
                and cfg.spiking.binarize_scores
                and not cfg.spiking.binarize_context
                and _launch_a_takes(x, d, heads, hd))
    s = lif_scan(x, cfg.spiking)[0]
    if not eligible:
        return _sequential_layer(p, st, cfg, x, s, train=train,
                                 engine=engine)
    plan = resolve_layer_plan(engine, s)
    dtype = x.dtype
    if all(quant):
        w3, sc3 = _layer_quant_w3(p, ("wq", "wk", "wv"), d, dtype)
    else:
        w3 = torch.stack([p[w]["w"].to(dtype) for w in ("wq", "wk", "wv")])
        sc3 = torch.ones((3, cfg.q_dim), dtype=torch.float32,
                         device=x.device)
    wo, sco = _layer_linear(p["wo"], cfg.q_dim, dtype)
    w1, sc1 = _layer_linear(p["w1"], d, dtype)
    w2, sc2 = _layer_linear(p["w2"], cfg.d_ff, dtype)
    aux1 = _bn_rows(p, st, "bn_1")
    w1, w2, sc1, aux1 = _pad_ff(w1, w2, sc1, aux1, heads)
    args = (x, s, w3, wo, w1, w2, (sc3, sco, sc1, sc2),
            torch.stack([_bn_rows(p, st, f"bn_{n}") for n in "qkv"]),
            _bn_rows(p, st, "bn_o"), aux1, _bn_rows(p, st, "bn_2"),
            p["delta"])
    y = _layer_program(args, cfg.spiking, plan, engine, family="bn",
                       num_heads=heads, head_dim=hd,
                       scale=1.0 / math.sqrt(hd), eps=1e-5)
    return y, dict(st)


def _sequential_layer(p, st, cfg, x, s, *, train, engine):
    """The sequential composition of one layer (JAX ``layer_step``'s
    fallback, term for term)."""
    from repro_torch.models import nn
    t, b, l, d = x.shape
    ctx, bundle_st = ssa_step(p, {n: st[n] for n in ("bn_q", "bn_k", "bn_v")},
                              cfg, s, train=train, engine=engine)
    new_st = dict(st, **bundle_st)

    def linear_bn(u, w, bn):
        # ctx carries integer counts, not {0,1} spikes: dark blocks are
        # dark all the same, so it rides the sparse engine too; with
        # analog scores it is an analog context (the config says so)
        y = nn.linear(p[w], u, spikes=True, counts=w == "wo",
                      analog=w == "wo" and not cfg.spiking.binarize_scores)
        y, new_st[bn] = nn.batchnorm(p[bn], st[bn], y.reshape(-1, y.shape[-1]),
                                     train=train)
        return y.reshape(*u.shape[:-1], -1)

    x = x + linear_bn(ctx, "wo", "bn_o")            # pre-neuron residual
    s2 = lif_scan(x, cfg.spiking)[0]
    h = lif_scan(linear_bn(s2, "w1", "bn_1"), cfg.spiking)[0]
    return x + linear_bn(h, "w2", "bn_2"), new_st   # pre-neuron residual


def ssa_step_causal(p: Dict[str, Any], cfg, h: torch.Tensor, positions, *,
                    train: bool = False,
                    engine: Optional[EngineConfig] = None) -> torch.Tensor:
    """The token-family SSA bundle (causal, RoPE epilogues): Q/K/V
    projections (+ RoPE + LIF) and causal binary attention. h: (T, B, S,
    D) normed currents (post ln1); positions: (S,). Returns the pre-wo
    context (T, B, S, q_dim).

    An eligible bundle (JAX's eligibility, term for term, and widths the
    kernel takes: :func:`_launch_a_takes`) under
    ``overlap='fused'`` or ``'pipeline'`` runs the bundle kernel's rope
    family (causal) on
    the stacked weights — int8 codes cast to ``h.dtype`` with their
    (3, q_dim) scales — and the [cos; sin] table of ``nn.rope_table``
    (the sequential path's), through :class:`_FusedBundle`; everything
    else runs the sequential composition. The mixed-precision LM tree
    (int8 wq, wk, wv only) reaches the kernel here: its layers are not
    eligible for the layer program."""
    from repro_torch.core.attention import spiking_attention
    from repro_torch.models import nn
    from repro_torch.models.transformer import _project_qkv
    engine = engine if engine is not None else get_engine()
    t, b, s_len, d = h.shape
    heads, hd = cfg.num_heads, cfg.head_dim
    names = ("wq", "wk", "wv")
    quant = ["qw" in p[w] for w in names]
    positions = torch.as_tensor(positions)
    eligible = (not cfg.qk_norm
                and cfg.num_kv_heads == cfg.num_heads
                and (all(quant) or not any(quant))
                and not any("b" in p[w] for w in names)
                and (all(quant) or h.dtype == torch.float32)
                and cfg.head_dim % 2 == 0
                and positions.ndim == 1
                and _launch_a_takes(h, d, heads, hd, rope=True))
    if eligible and resolve_overlap(engine, h) in ("fused", "pipeline"):
        if all(quant):
            w3, scale3 = _layer_quant_w3(p, names, d, h.dtype)
        else:
            w3 = torch.stack([p[w]["w"] for w in names])
            scale3 = None
        cos, sin = nn.rope_table(positions.to(h.device), hd, cfg.rope_theta)
        spec = BundleSpec("rope", heads, hd, 1.0 / math.sqrt(hd), True,
                          cfg.spiking, 1e-5)
        delta = torch.as_tensor(p["delta"], dtype=torch.float32,
                                device=h.device)
        return _FusedBundle.apply(h, w3, scale3, torch.stack([cos, sin]),
                                  delta, spec)
    q, k, v = _project_qkv(p, cfg, h, positions, repeat_kv=True)
    q, k, v = (lif_scan(u, cfg.spiking)[0] for u in (q, k, v))
    # (T, B, S, H, hd) -> (T*B, H, S, hd)
    fold = lambda u: u.reshape(-1, *u.shape[2:]).transpose(1, 2)
    ctx = spiking_attention(fold(q), fold(k), fold(v), cfg.spiking,
                            delta_score=p["delta"], causal=True,
                            engine=engine)
    return ctx.transpose(1, 2).reshape(t, b, s_len, cfg.q_dim)


def layer_step_causal(p: Dict[str, Any], cfg, x: torch.Tensor, positions,
                      *, train: bool = False,
                      engine: Optional[EngineConfig] = None
                      ) -> torch.Tensor:
    """The token-family layer program: ln1 + SSA bundle + wo + residual +
    ln2 + spiking MLP + residual. x: (T, B, S, D) residual-stream
    currents; positions: (S,). Returns the new residual stream.

    Eligibility is JAX's: no qk_norm, no GQA, a plain (up, down) MLP,
    all-or-none quantization, bias-free linears, fp32 activations unless
    quantized, even head_dim, 1-D positions, binarized scores with an
    analog context; and widths that launch A takes
    (:func:`_launch_a_takes`). An eligible layer runs the sequential oracle
    ``reference_layer`` (``overlap='off'``) or the layer program
    ``fused_layer`` with family 'rope' (``overlap='fused'`` or
    ``'pipeline'``: the CUDA kernel for CUDA tensors; a 'decoded' plan
    takes the tile projection,
    as in JAX, since the projection input is analog). Others run the
    sequential composition through :func:`ssa_step_causal`. ``train``
    changes no route, as in JAX (the eligibility has no train term): an
    eligible layer trains through :class:`_FusedLayer`, whose backward
    differentiates ``reference_layer``, or through ``reference_layer``
    itself under ``overlap='off'``; the sequential composition passes it
    on to :func:`ssa_step_causal`."""
    from repro_torch.models import nn
    engine = engine if engine is not None else get_engine()
    t, b, s_len, d = x.shape
    heads, hd = cfg.num_heads, cfg.head_dim
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    mlp = p["mlp"]
    lin_ps = [p["wq"], p["wk"], p["wv"], p["wo"], mlp.get("up"),
              mlp.get("down")]
    quant = ["qw" in q for q in lin_ps if q is not None]
    positions = torch.as_tensor(positions)
    eligible = (not cfg.qk_norm
                and cfg.num_kv_heads == cfg.num_heads
                and set(mlp) == {"up", "down"}
                and (all(quant) or not any(quant))
                and not any(q is not None and "b" in q for q in lin_ps)
                and (all(quant) or x.dtype == torch.float32)
                and hd % 2 == 0
                and positions.ndim == 1
                and cfg.spiking.binarize_scores
                and not cfg.spiking.binarize_context
                and _launch_a_takes(x, d, heads, hd, rope=True))
    if not eligible:
        attn = ssa_step_causal(p, cfg, h, positions, train=train,
                               engine=engine)
        x = x + nn.linear(p["wo"], attn)
        h2 = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
        hidden = lif_scan(nn.linear(mlp["up"], h2), cfg.spiking)[0]
        return x + nn.linear(mlp["down"], hidden)
    plan = resolve_layer_plan(engine, h)
    dtype = x.dtype
    if all(quant):
        w3, sc3 = _layer_quant_w3(p, ("wq", "wk", "wv"), d, dtype)
    else:
        w3 = torch.stack([p[w]["w"] for w in ("wq", "wk", "wv")])
        sc3 = torch.ones((3, cfg.q_dim), dtype=torch.float32,
                         device=x.device)
    d_ff = (mlp["up"]["qw"] if "qw" in mlp["up"] else mlp["up"]["w"]
            ).shape[-1]
    wo, sco = _layer_linear(p["wo"], cfg.q_dim, dtype)
    w1, sc1 = _layer_linear(mlp["up"], d, dtype)
    w2, sc2 = _layer_linear(mlp["down"], d_ff, dtype)
    w1, w2, sc1, _ = _pad_ff(w1, w2, sc1, None, heads)
    cos, sin = nn.rope_table(positions, hd, cfg.rope_theta)
    args = (x, h, w3, wo, w1, w2, (sc3, sco, sc1, sc2),
            torch.stack([cos, sin]),
            p["ln2"]["scale"].float().reshape(1, d), None, None, p["delta"])
    return _layer_program(args, cfg.spiking, plan, engine, family="rope",
                          num_heads=heads, head_dim=hd,
                          scale=1.0 / math.sqrt(hd), causal=True,
                          norm_eps=cfg.norm_eps)
