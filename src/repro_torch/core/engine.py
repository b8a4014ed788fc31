"""Dual-engine dispatch for the layer program (the subset the eval path
of the vision family needs).

Mirrors ``repro.core.engine``: ``EngineConfig`` and its validation, the
ambient engine (``use_engine`` / ``engine_scope``), the static dispatch
rules, and the eligible branch of ``layer_step``, which hands a whole
encoder layer either to the sequential oracle (``overlap='off'``) or to
the fused layer program (``overlap='fused'``, ``kernels/fused_layer``).

Not ported yet, and raising ``NotImplementedError`` instead of falling
back silently: ``sparse='decoded'``, ``overlap='pipeline'``, the
ineligible / train branch of ``layer_step``, ``ssa_step``,
``spike_linear`` and the sequential composition (ROADMAP queue 1 items
3 and 5, queue 2).
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP {item})")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Dual-engine dispatch knobs (per model, set on ModelConfig.engine):
    the fields of ``repro.core.engine.EngineConfig`` that the layer
    program reads, with the same meaning and validation. ``block_m`` is
    the L-block of the layer program's occupancy skip. JAX's
    ``min_flops`` is left out: the port's 'auto' does not read it (see
    :func:`resolve_overlap`)."""
    sparse: str = "tile"
    block_m: int = 128
    overlap: str = "off"

    def __post_init__(self):
        if self.sparse not in SPARSE_PATHS + ("auto",):
            raise ValueError(f"unknown sparse datapath {self.sparse!r} "
                             f"(expected tile|decoded|auto)")
        if self.overlap not in OVERLAP_MODES + ("auto",):
            raise ValueError(f"unknown overlap mode {self.overlap!r} "
                             f"(expected off|fused|pipeline|auto)")

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


def resolve_sparse_path(engine: Optional[EngineConfig], x=None) -> str:
    """Tile-vs-decoded decision for the projection datapath.

    The JAX rule resolves 'auto' to 'tile' on a TPU (and under jit); on
    the GPU the decoded gather is not ported yet, so 'auto' resolves
    'tile' on every device, and an explicit 'decoded' raises."""
    if engine is None or engine.sparse in ("tile", "auto"):
        return "tile"
    raise _not_ported("sparse='decoded'", "queue 2 item 4")


def resolve_overlap(engine: Optional[EngineConfig], x=None) -> str:
    """Fused-vs-sequential decision for a layer step.

    JAX fuses under 'auto' when the input is concrete, off the TPU, and
    the flops reach ``min_flops``; the flop floor keeps small layers out
    of interpret mode. A PyTorch tensor is always concrete, and the fused
    kernel's home is now the card, where it is built and checked against
    its plain version and has no interpret mode. So 'auto' fuses whenever
    ``x`` lies on a CUDA device, whatever the layer's size, and the
    wrapper there launches the kernel or raises; on the CPU 'auto' stays
    'off' and takes the oracle, as JAX does under jit."""
    if engine is None:
        return "off"
    if engine.overlap == "pipeline":
        raise _not_ported("overlap='pipeline'", "queue 2 item 3")
    if engine.overlap in ("off", "fused"):
        return engine.overlap
    if x is not None and x.device.type == "cuda":
        return "fused"
    return "off"


class LayerPlan(NamedTuple):
    """The static execution plan of a whole-layer step."""
    overlap: str
    sparse: str


def resolve_layer_plan(engine: Optional[EngineConfig], x=None) -> LayerPlan:
    return LayerPlan(resolve_overlap(engine, x),
                     resolve_sparse_path(engine, x))


def spike_linear(p, x, *, engine=None, counts=False):
    """The sparse engine's per-matmul dispatch (dense vs block-sparse
    spike matmul). Not ported yet: the eval layer program does not call
    it, the training slice does."""
    raise _not_ported("spike_linear (the spike_matmul kernel)",
                      "queue 2 item 1")


def ssa_step(p, st, cfg, s, *, train=False, engine=None):
    """The SSA bundle step of the sequential composition. Not ported yet."""
    raise _not_ported("ssa_step (the sequential composition)",
                      "queue 1 item 3")


def _layer_linear(p: Dict[str, Any], dtype: torch.dtype):
    """(weight, fp32 ones scale) for one fp layer linear."""
    if "qw" in p:
        raise _not_ported("quantized weights", "queue 1 item 6")
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
    step. x: (T, B, L, D) membrane currents. Returns (y, BN state).

    Only the eligible eval branch is ported: ``overlap='off'`` runs the
    sequential oracle ``reference_layer`` and ``overlap='fused'`` the
    layer program ``fused_layer`` (the CUDA kernel for CUDA tensors)."""
    from repro_torch.kernels.fused_layer import fused_layer, reference_layer
    engine = engine if engine is not None else get_engine()
    heads, hd = cfg.num_heads, cfg.head_dim
    lin_names = ("wq", "wk", "wv", "wo", "w1", "w2")
    eligible = (not train
                and not any("b" in p[w] for w in lin_names)
                and cfg.spiking.binarize_scores
                and not cfg.spiking.binarize_context)
    if not eligible:
        raise _not_ported("the sequential (train / ineligible) layer "
                          "composition", "queue 1 items 3 and 5")
    s = lif_scan(x, cfg.spiking)[0]
    plan = resolve_layer_plan(engine, s)
    dtype = x.dtype
    w3 = torch.stack([_layer_linear(p[w], dtype)[0]
                      for w in ("wq", "wk", "wv")])
    sc3 = torch.ones((3, cfg.q_dim), dtype=torch.float32, device=x.device)
    wo, sco = _layer_linear(p["wo"], dtype)
    w1, sc1 = _layer_linear(p["w1"], dtype)
    w2, sc2 = _layer_linear(p["w2"], dtype)
    aux1 = _bn_rows(p, st, "bn_1")
    w1, w2, sc1, aux1 = _pad_ff(w1, w2, sc1, aux1, heads)
    args = (x, s, w3, wo, w1, w2, (sc3, sco, sc1, sc2),
            torch.stack([_bn_rows(p, st, f"bn_{n}") for n in "qkv"]),
            _bn_rows(p, st, "bn_o"), aux1, _bn_rows(p, st, "bn_2"),
            p["delta"])
    scfg = cfg.spiking
    kw = dict(family="bn", num_heads=heads, head_dim=hd,
              scale=1.0 / math.sqrt(hd), eps=1e-5)
    if plan.overlap == "off":
        y = reference_layer(*args, scfg, **kw)
    else:
        y, _ = fused_layer(
            *args, sparse=plan.sparse, decay=scfg.decay,
            v_th=scfg.v_threshold, soft_reset=scfg.soft_reset,
            l_block=engine.block_m, **kw)
    return y, dict(st)
