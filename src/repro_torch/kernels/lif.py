"""Fused LIF membrane update over T time steps.

Port of ``repro.kernels.lif.lif_forward``: currents ``(T, M, D)`` in
fp32 or bf16 -> spikes ``(T, M, D)`` in the same dtype, with the
membrane kept in fp32 across the time loop (the TPU kernel's VMEM
scratch), whatever the input dtype. Three functions:

* :func:`lif_forward_plain` — the plain PyTorch version;
* :func:`lif_forward` — the wrapper: CPU tensors take the plain
  version, CUDA tensors launch ``csrc/lif.cu`` through
  :func:`lif_forward_cuda` or raise.

Each step is ``u = decay * u + i[t]`` with ``i[t]`` cast to fp32,
rounded as the interpret-mode Pallas kernel rounds it: XLA contracts it
into one fused multiply-add, so both versions compute ``fma32(u, decay,
i[t])`` (``models/nn.fma32``). A neuron fires when ``u >= v_th``; the
reset is hard (``u * (1 - s)``) or soft (``u - s * v_th``).

This differs from ``core/spiking.lif_scan``, which keeps the membrane
in the activation dtype and rounds the product and the sum apart (as
PyTorch does): the two agree bitwise in fp32 wherever ``decay * u`` is
exact (decay 0.5, the models' tau of 2), and not in bf16. The JAX
kernel asserts that M is a multiple of its 256-row block past 256 rows;
this one takes any M and D.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.models.nn import fma32

# kernel launches on the card (one per call of lif_forward_cuda)
LAUNCHES = {"lif_forward": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["lif_forward"] = 0


def lif_forward_plain(currents: torch.Tensor, *, decay: float,
                      v_th: float = 1.0, soft_reset: bool = False
                      ) -> torch.Tensor:
    """Plain version: (T, M, D) spikes in ``currents.dtype``."""
    th = torch.tensor(v_th, dtype=torch.float32, device=currents.device)
    u = torch.zeros(currents.shape[1:], dtype=torch.float32,
                    device=currents.device)
    out = torch.empty_like(currents)
    for t in range(currents.shape[0]):
        u = fma32(u, decay, currents[t].float())
        s = (u >= th).float()
        u = u - s * th if soft_reset else u * (1.0 - s)
        out[t] = s.to(currents.dtype)
    return out


def _check(currents: torch.Tensor) -> None:
    if currents.dim() != 3:
        raise ValueError(f"lif_forward takes (T, M, D) currents, got "
                         f"{tuple(currents.shape)}")
    if currents.dtype not in _DTYPES:
        raise ValueError(f"lif_forward takes float32 or bfloat16 currents, "
                         f"got {currents.dtype}")


def lif_forward(currents: torch.Tensor, *, decay: float, v_th: float = 1.0,
                soft_reset: bool = False) -> torch.Tensor:
    """currents: (T, M, D) -> spikes (T, M, D) in the same dtype."""
    _check(currents)
    kw = dict(decay=decay, v_th=v_th, soft_reset=soft_reset)
    if currents.device.type == "cpu":
        return lif_forward_plain(currents, **kw)
    if currents.device.type != "cuda":
        raise ValueError(f"lif_forward runs on CPU or CUDA tensors, not "
                         f"{currents.device.type}")
    return lif_forward_cuda(currents, **kw)


def _library():
    from repro_torch.kernels import _build
    lib = _build.load("lif")
    if lib.lif_forward.argtypes is None:
        lib.lif_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 2
            + [ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
               ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.lif_forward.restype = ctypes.c_int
        lib.lif_error.argtypes = [ctypes.c_int]
        lib.lif_error.restype = ctypes.c_char_p
    return lib


def lif_forward_cuda(currents: torch.Tensor, *, decay: float,
                     v_th: float = 1.0, soft_reset: bool = False
                     ) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    _check(currents)
    if not currents.is_contiguous():
        raise ValueError("lif_forward kernel takes contiguous currents")
    out = torch.empty_like(currents)
    if out.numel() == 0:
        return out
    t = currents.shape[0]
    n = currents.numel() // t
    lib = _library()
    stream = torch.cuda.current_stream(currents.device).cuda_stream
    rc = lib.lif_forward(_DTYPES[currents.dtype], currents.data_ptr(),
                         out.data_ptr(), t, n, float(decay), float(v_th),
                         int(soft_reset), stream)
    if rc != 0:
        raise RuntimeError(f"lif_forward kernel launch failed: "
                           f"{lib.lif_error(rc).decode()}")
    LAUNCHES["lif_forward"] += 1
    return out
