"""Block-sparse spike matmul — the sparse engine's product.

Port of ``repro.kernels.spike_matmul.spike_matmul``: ``y = s @ w (+ b)``
for {0,1} spikes (or small integer counts) ``s: (M, K)`` against
weights ``w: (K, N)``, accumulated in fp32, skipping all-zero spike
tiles; and of its int8 twin ``quant_spike_matmul`` (below). Three
functions of the fp product:

* :func:`spike_matmul_plain` — the plain PyTorch version: the dense
  fp32 product (a skipped tile adds exact zeros, so skipping does not
  change the result), then the bias, rounded once to the operands'
  dtype;
* :func:`spike_matmul` — the wrapper: CPU tensors take the plain
  version, CUDA tensors launch ``csrc/spike_matmul.cu`` through
  :func:`spike_matmul_cuda` or raise;
* :func:`block_occupancy` — the TPU kernel's ``(nM, nK)`` map of live
  spike tiles (any non-zero entry per tile).

Both products run on one CUDA tile skeleton: a block owns 128 rows by
256 columns of the output and walks K in 32-deep chunks, which arrive
through a ring in shared memory; a chunk of ``s`` whose every entry is
dark costs no weight copy and no product. :data:`SKIP_TILE` is that
chunk of ``s``, (rows, columns): finer than the TPU kernel's default
128 x 128, it skips every tile the TPU kernel would, and more, with the
same result. Both return the fp32 accumulator rounded once to the
operands' dtype — the JAX kernel's default ``out_dtype``
(``w.dtype``). The engine's operands carry the activation dtype, so the
cast that JAX's engine applies to the kernel's fp32 output is fused
into the kernel's store (``core/engine.spike_linear``).

An analog left operand (``analog=True``: the wo product on the analog
context of a ``binarize_scores=False`` layer, exact in no order) takes
the analog mode: both versions sum every output in ascending k, one fp32
product and one fp32 sum a term (``fused_ssa.seq_matmul``), the bias
after the last term, so the kernel (``csrc/spike_matmul.cu``'s
``analog_product``, CUDA cores) and the plain version agree bitwise. The
caller chooses the mode from the config, never from the values.

The quantized product ``y = (s @ qw) * scale (+ b)`` takes spikes on
int8 lanes (or, with ``counts=True``, binary-attention counts on int32
lanes) against int8 weight codes, sums in int32 (exact in any order)
and applies the per-channel fp32 scale in the epilogue:
:func:`quant_spike_matmul_plain`, :func:`quant_spike_matmul` (the
wrapper) and :func:`quant_spike_matmul_cuda` (``csrc/spike_matmul.cu``).
The CUDA wrapper hands the kernel ``s`` as it comes in fp32 or bf16
(:func:`lane_operand`), and the kernel casts each value to its lane as
it stages it (:func:`quant_lanes`' cast: truncation toward zero; a spike
lane keeps the low byte). Both versions round the epilogue as the
interpret-mode Pallas kernel does: ``acc * scale`` once, and with a bias
``fma32(acc, scale, b)``, since jitted XLA contracts ``acc * scale + b``
into one fused multiply-add. The result is the fp32 epilogue rounded
once to ``out_dtype`` (JAX's kernel output followed by the engine's
cast).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

# kernel launches on the card (one per call of spike_matmul_cuda, in its
# analog mode under its own name, or quant_spike_matmul_cuda)
LAUNCHES = {"spike_matmul": 0, "spike_matmul_analog": 0,
            "quant_spike_matmul": 0}
# the CUDA kernels' skip tile of s: the rows of an output tile and the
# depth of a contraction chunk (csrc/spike_matmul.cu BM, BK)
SKIP_TILE = (128, 32)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def block_occupancy(s: torch.Tensor, block_m: int, block_k: int
                    ) -> torch.Tensor:
    """(M, K) spikes -> (M / block_m, K / block_k) int32, 1 where the tile
    holds a non-zero entry. M and K must be multiples of the blocks."""
    m, k = s.shape
    occ = (s != 0).reshape(m // block_m, block_m, k // block_k, block_k)
    return occ.any(dim=3).any(dim=1).to(torch.int32)


def spike_matmul_plain(s: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       analog: bool = False) -> torch.Tensor:
    """Plain version of the kernel: (M, N) ``s @ w`` (+ bias) accumulated
    in fp32, rounded once to ``s.dtype``; with ``analog`` summed in
    ascending k, one rounded product and one rounded sum a term."""
    if analog:
        from repro_torch.kernels.fused_ssa import seq_matmul
        y = seq_matmul(s, w)
    else:
        y = s.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(s.dtype)


def spike_matmul(s: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 analog: bool = False) -> torch.Tensor:
    """y = s @ w (+ bias) -> (M, N) in ``s.dtype``, accumulated in fp32.
    s: (M, K) {0,1} spikes or non-negative integer counts, or with
    ``analog`` any values (summed in ascending k); w: (K, N); bias: (N,)
    or None."""
    if s.dim() != 2 or w.dim() != 2 or s.shape[1] != w.shape[0]:
        raise ValueError(f"spike_matmul takes s (M, K) and w (K, N), got "
                         f"{tuple(s.shape)} and {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"bias has shape {tuple(bias.shape)}, expected "
                         f"({w.shape[1]},)")
    if s.device.type == "cpu":
        return spike_matmul_plain(s, w, bias, analog=analog)
    if s.device.type != "cuda":
        raise ValueError(f"spike_matmul runs on CPU or CUDA tensors, not "
                         f"{s.device.type}")
    return spike_matmul_cuda(s, w, bias, analog=analog)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    from repro_torch.kernels import _build
    lib = _build.load("spike_matmul")
    if lib.spike_matmul_forward.argtypes is None:
        lib.spike_matmul_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.spike_matmul_forward.restype = ctypes.c_int
        lib.spike_matmul_analog_forward.argtypes = \
            lib.spike_matmul_forward.argtypes
        lib.spike_matmul_analog_forward.restype = ctypes.c_int
        lib.quant_spike_matmul_forward.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.quant_spike_matmul_forward.restype = ctypes.c_int
        lib.spike_matmul_error.argtypes = [ctypes.c_int]
        lib.spike_matmul_error.restype = ctypes.c_char_p
    return lib


def spike_matmul_cuda(s: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, *,
                      analog: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (with
    ``analog``, its analog mode). s and w share one dtype (float32 or
    bfloat16), which the output takes, and are contiguous."""
    if s.dtype not in _DTYPES or w.dtype != s.dtype:
        raise ValueError(f"spike_matmul kernel takes s and w of one dtype, "
                         f"float32 or bfloat16, got {s.dtype} and {w.dtype}")
    operands = (s, w) if bias is None else (s, w, bias)
    for a in operands:
        if a.device != s.device:
            raise ValueError("all spike_matmul operands must be on one "
                             "device")
        if not a.is_contiguous():
            raise ValueError("spike_matmul kernel takes contiguous operands")
    m, k = s.shape
    n = w.shape[1]
    b32 = None if bias is None else bias.float().contiguous()
    out = torch.empty((m, n), dtype=s.dtype, device=s.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(s.device).cuda_stream
    forward = lib.spike_matmul_analog_forward if analog \
        else lib.spike_matmul_forward
    rc = forward(_DTYPES[s.dtype], s.data_ptr(), w.data_ptr(),
                 None if b32 is None else b32.data_ptr(), out.data_ptr(), m,
                 k, n, stream)
    if rc != 0:
        raise RuntimeError(f"spike_matmul kernel launch failed: "
                           f"{lib.spike_matmul_error(rc).decode()}")
    LAUNCHES["spike_matmul_analog" if analog else "spike_matmul"] += 1
    return out


# ---------------------------------------------------------------------------
# the quantized product (``quant_spike_matmul``)
# ---------------------------------------------------------------------------


def quant_lanes(s: torch.Tensor, counts: bool) -> torch.Tensor:
    """The left operand on the kernel's integer lanes, as the JAX kernel
    casts it: int8 for {0,1} spikes, int32 for binary-attention counts
    (which wrap int8 at 128)."""
    return s.to(torch.int32 if counts else torch.int8)


def quant_epilogue(acc: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 epilogue of an exact integer sum ``acc`` (any integer or
    integer-valued dtype): rounded once to fp32, then ``* scale``, or
    with a bias one fused multiply-add (``fma32``), the contraction the
    jitted kernel makes."""
    from repro_torch.models.nn import fma32
    acc = acc.float()
    if bias is None:
        return acc * scale.float()
    return fma32(acc, scale.float(), bias.float())


def _check_quant(name, s, qw, scale, bias):
    if s.dim() != 2 or qw.dim() != 2 or s.shape[1] != qw.shape[0]:
        raise ValueError(f"{name} takes s (M, K) and qw (K, N), got "
                         f"{tuple(s.shape)} and {tuple(qw.shape)}")
    if qw.dtype != torch.int8:
        raise ValueError(f"{name} takes int8 weight codes, got {qw.dtype} "
                         f"(unpack int4 nibbles first)")
    n = qw.shape[1]
    for what, a in (("scale", scale), ("bias", bias)):
        if a is not None and tuple(a.shape) != (n,):
            raise ValueError(f"{what} has shape {tuple(a.shape)}, expected "
                             f"({n},)")


def quant_spike_matmul_plain(s: torch.Tensor, qw: torch.Tensor,
                             scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             counts: bool = False,
                             out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Plain version of the kernel: the integer sums of ``s`` on its lanes
    against the codes, taken in float64 (exact: every partial sum is an
    integer far below 2^53), then :func:`quant_epilogue`, rounded once to
    ``out_dtype``."""
    acc = quant_lanes(s, counts).double() @ qw.double()
    return quant_epilogue(acc, scale, bias).to(out_dtype)


def quant_spike_matmul(s: torch.Tensor, qw: torch.Tensor,
                       scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       counts: bool = False,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """y = (s @ qw) * scale (+ bias) -> (M, N) in ``out_dtype``. s: (M, K)
    {0,1} spikes, or with ``counts`` non-negative integer counts, in any
    dtype; qw: (K, N) int8 codes; scale, bias: (N,)."""
    _check_quant("quant_spike_matmul", s, qw, scale, bias)
    kw = dict(counts=counts, out_dtype=out_dtype)
    if s.device.type == "cpu":
        return quant_spike_matmul_plain(s, qw, scale, bias, **kw)
    if s.device.type != "cuda":
        raise ValueError(f"quant_spike_matmul runs on CPU or CUDA tensors, "
                         f"not {s.device.type}")
    return quant_spike_matmul_cuda(s, qw, scale, bias, **kw)


_LANE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def lane_operand(s: torch.Tensor, counts: bool):
    """(s as the int8 products' kernels read it, its type code): fp32 and
    bf16 values stay as they are (the kernels cast each to its lane on
    the device); any other dtype goes to its lanes first
    (:func:`quant_lanes`: code 2 for int8 spike lanes, 3 for int32 count
    lanes)."""
    if s.dtype not in _LANE_CODES:
        s = quant_lanes(s, counts)
    code = _LANE_CODES.get(s.dtype, 3 if counts else 2)
    return s.contiguous(), code


def quant_operands(name, s, qw, scale, bias, counts, out_dtype):
    """Checks and lays out a quantized product's operands for its CUDA
    kernel: (s as it reads it and its type code, :func:`lane_operand`;
    qw, fp32 scale, fp32 bias or None; the output dtype's code), all
    contiguous on one device."""
    if out_dtype not in _DTYPES:
        raise ValueError(f"{name} kernel writes float32 or bfloat16, not "
                         f"{out_dtype}")
    s, code = lane_operand(s, counts)
    ops = [qw.contiguous(), scale.float().contiguous(),
           None if bias is None else bias.float().contiguous()]
    for a in ops:
        if a is not None and a.device != s.device:
            raise ValueError(f"all {name} operands must be on one device")
    return (s, code, *ops, _DTYPES[out_dtype])


def quant_spike_matmul_cuda(s: torch.Tensor, qw: torch.Tensor,
                            scale: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, *,
                            counts: bool = False,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream: ``s`` in fp32
    or bf16 as it comes (any other dtype cast to its lanes first, int8,
    or int32 with ``counts``), int8 codes, fp32 scale and bias; the
    output in ``out_dtype`` (float32 or bfloat16)."""
    s, code, qw, sc, b32, out_code = quant_operands(
        "quant_spike_matmul", s, qw, scale, bias, counts, out_dtype)
    m, k = s.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=s.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(s.device).cuda_stream
    rc = lib.quant_spike_matmul_forward(
        code, int(counts), out_code, s.data_ptr(), qw.data_ptr(),
        sc.data_ptr(), None if b32 is None else b32.data_ptr(),
        out.data_ptr(), m, k, n, stream)
    if rc != 0:
        raise RuntimeError(f"quant_spike_matmul kernel launch failed: "
                           f"{lib.spike_matmul_error(rc).decode()}")
    LAUNCHES["quant_spike_matmul"] += 1
    return out
