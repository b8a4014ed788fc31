"""Fine-grained sparse-decoder datapath: the gather-compacted spike matmul.

Port of ``repro.kernels.spike_decode``. The tile kernel
(``spike_matmul``) skips whole spike tiles; this datapath skips at the
grain of single spikes, as the paper's decoder does:

* decode: each row's non-zero K-indices are prefix-compacted, ascending
  (:func:`decode_indices`; the rank of a set bit is the lane and cycle
  of the M-lane carry-lookahead decoder that fires it);
* dispatch: only the live weight rows ``w[idx]`` enter the contraction;
* load balancing: rows sort by occupancy into ``block_m`` groups, each
  group's capacity rounded up to a power of two (:func:`build_schedule`);
  chunks of ``c_block`` compacted slots at or past a group's capacity are
  skipped.

The staging functions (:func:`pow2ceil`, :func:`decode_indices`,
:func:`build_schedule`, :func:`choose_sparse_path`, :func:`slab_decode`)
are plain PyTorch and equal the JAX functions element for element. Beside
them:

* :func:`gather_spike_matmul_plain` — the plain version of the kernel:
  ``y = s @ w (+ bias)`` summed over each row's live slots in ascending
  k, one fp32 product and one fp32 sum at a time, the bias after the last
  slot, rounded once to ``s.dtype``;
* :func:`gather_spike_matmul` — the wrapper: CPU tensors take the plain
  version, CUDA tensors launch ``csrc/gather_spike_matmul.cu`` through
  :func:`gather_spike_matmul_cuda` or raise. The CUDA path stages on the
  device (:func:`gather_stage`: each row's occupancy, live bits and
  whether every live value is 1, and a stable counting sort by occupancy
  whose order equals :func:`stage_rows`', the staging's plain version)
  and walks each row's staged live bits in ascending k on the CUDA cores
  (:func:`launch_gather`), one rounded add an entry, as the plain
  version sums.

and the quantized twins (``quant_gather_spike_matmul``: int8 spike or
int32 count lanes against int8 codes, int32 sums, the per-channel scale
in the epilogue) :func:`quant_gather_spike_matmul_plain`,
:func:`quant_gather_spike_matmul` and
:func:`quant_gather_spike_matmul_cuda`; their sums are exact, so they
equal ``spike_matmul.quant_spike_matmul`` bitwise on any weights and
scales. The CUDA path stages on the device (:func:`quant_stage`: the
lane cast, each row's occupancy and live bits, and the same counting
sort) and runs the product on the int8 tensor cores over each block's
union of live lanes (:func:`launch_quant_gather`). Its arithmetic has
plain twins here: :func:`lane_values` (the cast), and
:func:`lane_planes`, :func:`split_planes` and :func:`join_planes`
(counts in byte planes). The two stagings differ in what is live: #4's
tests the value (``s != 0``), #5's the value's integer lane, so a value
in (-1, 1) is live for #4 and dark for #5.

The values of ``s`` are carried, not a live mask, so the integer counts
of a binary-attention context (the wo projection's input) are exact too.
The JAX kernel returns fp32 and its engine casts to the activation dtype;
the port's wrapper rounds the fp32 sum once to ``s.dtype`` in the
kernel's store, as ``spike_matmul`` does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.spike_matmul import lane_operand, quant_operands

# Crossover factor of sparse='auto': a decoded multiply-add costs more
# than a tile one, so the decoded path must cut the modeled work by at
# least this factor below the tile path's before 'auto' picks it.
DECODED_OVERHEAD = 2.0

# kernel launches on the card: one per launch of a product's kernel, and
# one per staging of a product (its two kernels, :func:`gather_stage` or
# :func:`quant_stage`)
LAUNCHES = {"gather_spike_matmul": 0, "gather_stage": 0,
            "quant_gather_spike_matmul": 0, "quant_gather_stage": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pad_to_multiple(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to the next multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    widths = [0, 0] * (x.dim() - axis % x.dim())
    widths[-1] = pad
    return F.pad(x, widths)


def pow2ceil(x: torch.Tensor) -> torch.Tensor:
    """Elementwise smallest power of two >= x (0 -> 0, 1 -> 1), int32, by
    smearing the bits of x - 1: integer-exact, no float log2."""
    x = x.to(torch.int32)
    v = torch.clamp(x, min=1) - 1
    for shift in (1, 2, 4, 8, 16):
        v = v | (v >> shift)
    return torch.where(x <= 1, torch.clamp(x, min=0), v + 1)


def decode_indices(s: torch.Tensor, cap: Optional[int] = None):
    """Compact each row's non-zero K-indices by cumsum prefix compaction.

    s: (M, K). Returns (idx (M, cap) int32, occ (M,) int32): ``idx[m,
    :occ[m]]`` are the positions of row m's non-zeros, ascending; padding
    slots hold 0. ``cap`` (default K) bounds the compacted width; a row
    with more non-zeros would be cut, so a ``cap`` below K is checked
    against the rows' occupancy (one read from the device)."""
    m, k = s.shape
    bits = s != 0
    occ = bits.sum(-1, dtype=torch.int32)
    cap = k if cap is None else min(cap, k)
    if cap < k:
        hi = int(occ.max()) if m else 0
        if hi > cap:
            raise ValueError(f"decode cap {cap} < max row occupancy {hi}")
    rank = torch.cumsum(bits, dim=-1, dtype=torch.int32) - 1
    slot = torch.where(bits, rank, cap)            # dead bits -> spill slot
    cols = torch.arange(k, dtype=torch.int32, device=s.device).expand(m, k)
    idx = torch.zeros((m, cap + 1), dtype=torch.int32, device=s.device)
    idx.scatter_(1, slot.long(), cols)
    return idx[:, :cap], occ


def build_schedule(occ: torch.Tensor, block_m: int, c_block: int, cap: int):
    """Occupancy-binned load-balancing schedule. Rows sort ascending by
    occupancy (a stable sort, as ``jnp.argsort``) into ``block_m`` groups;
    each group's capacity is its largest occupancy rounded up to a power
    of two, clipped to the padded compacted width.

    occ: (M,) int32 with M a multiple of ``block_m``. Returns a dict with
    ``order`` (the row permutation), per-group ``caps`` and ``steps``
    (executed ``c_block`` chunks), ``executed`` / ``total`` chunk counts
    per N tile, ``padded_cap`` and ``mac_fraction`` = executed / total.
    Reads nothing back from the device."""
    m = occ.shape[0]
    assert m % block_m == 0, f"pad rows first: {m} % {block_m}"
    cp = max(c_block, -(-cap // c_block) * c_block)
    order = torch.argsort(occ, stable=True)
    gmax = occ[order].reshape(m // block_m, block_m).amax(dim=1)
    caps = torch.clamp(pow2ceil(gmax), max=cp).to(torch.int32)
    steps = -(-caps // c_block)
    executed = steps.sum(dtype=torch.int32)
    total = (m // block_m) * (cp // c_block)
    return {"order": order, "caps": caps, "steps": steps,
            "executed": executed, "total": total, "padded_cap": cp,
            "mac_fraction": executed / total}


def choose_sparse_path(s: torch.Tensor, block_m: int, block_k: int) -> str:
    """Tile-vs-decoded decision from the concrete occupancy histogram
    (``sparse='auto'``): the tile path's live-tile fraction against the
    bucket schedule's executed fraction of the compacted width, the
    decoded path handicapped by :data:`DECODED_OVERHEAD`. Costs one read
    from the device (both fractions at once)."""
    from repro_torch.kernels.spike_matmul import block_occupancy
    m, k = s.shape
    bm, bk = min(block_m, m), min(block_k, k)
    sp = pad_to_multiple(pad_to_multiple(s, 0, bm), 1, bk)
    tile_frac = block_occupancy(sp, bm, bk).float().mean()
    occ = (pad_to_multiple(s, 0, bm) != 0).sum(-1, dtype=torch.int32)
    sched = build_schedule(occ, bm, bk, cap=k)
    tile_frac, mac = torch.stack([tile_frac, sched["mac_fraction"].float()]
                                 ).tolist()
    dec_frac = mac * sched["padded_cap"] / max(k, 1)
    return "decoded" if dec_frac * DECODED_OVERHEAD < tile_frac else "tile"


def _stage(s: torch.Tensor, block_m: int, c_block: int,
           cap: Optional[int]):
    """Pad rows, decode, sort by occupancy, build the schedule. Returns
    (idx, vals, caps2d, order, schedule) with idx and vals in schedule
    order, padded to (Mp, Cp); vals carry the input values on live slots
    and exact zeros elsewhere."""
    sp = pad_to_multiple(s, 0, block_m)
    idx, occ = decode_indices(sp, cap=cap)
    sched = build_schedule(occ, block_m, c_block, cap=idx.shape[1])
    idx = pad_to_multiple(idx, 1, c_block)
    mask = (torch.arange(idx.shape[1], dtype=torch.int32, device=s.device
                         )[None] < occ[:, None])
    vals = torch.where(mask, torch.gather(sp, 1, idx.long()), 0)
    order = sched["order"]
    return idx[order], vals[order], sched["caps"].reshape(-1, 1), order, \
        sched


def slab_decode(s: torch.Tensor, *, l_block: int, c_block: int,
                cap: Optional[int] = None):
    """Stage the decoded datapath of the fused layer: per-(timestep,
    batch) slab row decode plus per-L-block pow2 capacities. Rows are not
    permuted (the fused layer needs them in sequence order): each L-block
    of ``l_block`` consecutive rows gets ``min(pow2ceil(max occupancy in
    the block), padded width)``.

    s: (T, B, L, K). Returns (idx (B, T, L, Cp) int32, vals (B, T, L, Cp)
    fp32, caps (B, T, ceil(L / l_block)) int32, c_block) with Cp a
    multiple of the (possibly clipped) c_block."""
    t, b, l, k = s.shape
    l_block = max(1, min(l_block, l))
    nlb = -(-l // l_block)
    flat = s.reshape(t * b * l, k)
    idx, occ = decode_indices(flat, cap=cap)
    c_block = max(1, min(c_block, idx.shape[1]))
    idx = pad_to_multiple(idx, 1, c_block)
    cp = idx.shape[1]
    mask = (torch.arange(cp, dtype=torch.int32, device=s.device)[None]
            < occ[:, None])
    vals = torch.where(mask, torch.gather(flat, 1, idx.long()), 0)
    occ_pad = pad_to_multiple(occ.reshape(t * b, l), 1, l_block)
    gmax = occ_pad.reshape(t * b, -1, l_block).amax(dim=2)[:, :nlb]
    caps = torch.clamp(pow2ceil(gmax), max=cp).to(torch.int32)
    idx = idx.reshape(t, b, l, cp).transpose(0, 1)
    vals = vals.reshape(t, b, l, cp).float().transpose(0, 1)
    caps = caps.reshape(t, b, nlb).transpose(0, 1)
    return idx, vals, caps, c_block


def gather_sum(idx: torch.Tensor, vals: torch.Tensor, w: torch.Tensor,
               n_slots: int) -> torch.Tensor:
    """sum_i vals[..., i] * w[idx[..., i]] over the first ``n_slots``
    compacted slots, in fp32, one rounded product and one rounded sum a
    slot in ascending order: the kernels' order. Slots that hold no live
    entry add exact zeros."""
    wf = w.float()
    acc = torch.zeros((*idx.shape[:-1], w.shape[1]), dtype=torch.float32,
                      device=w.device)
    for i in range(n_slots):
        acc = acc + vals[..., i, None].float() * wf[idx[..., i].long()]
    return acc


def gather_spike_matmul_plain(s: torch.Tensor, w: torch.Tensor,
                              bias: Optional[torch.Tensor] = None, *,
                              block_m: int = 128, c_block: int = 128
                              ) -> torch.Tensor:
    """Plain version of the kernel, through the JAX staging: rows sorted
    into groups, each group's slots walked up to its capacity, the sums
    un-permuted, the bias added, rounded once to ``s.dtype``."""
    m, k = s.shape
    block_m, c_block = min(block_m, m), min(c_block, k)
    idx, vals, caps2d, order, _ = _stage(s, block_m, c_block, None)
    n_slots = int(caps2d.max()) if caps2d.numel() else 0
    acc = gather_sum(idx, vals, w, n_slots)
    y = torch.empty_like(acc)
    y[order] = acc
    y = y[:m]
    if bias is not None:
        y = y + bias.float()
    return y.to(s.dtype)


def gather_spike_matmul(s: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, *,
                        block_m: int = 128, c_block: int = 128
                        ) -> torch.Tensor:
    """y = s @ w (+ bias) -> (M, N) in ``s.dtype`` through the decoded
    datapath. s: (M, K) spikes or integer counts; w: (K, N); bias: (N,)
    or None; ``block_m`` rows a schedule group, ``c_block`` compacted
    slots a chunk (both clipped to the shape)."""
    if s.dim() != 2 or w.dim() != 2 or s.shape[1] != w.shape[0]:
        raise ValueError(f"gather_spike_matmul takes s (M, K) and w (K, N), "
                         f"got {tuple(s.shape)} and {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"bias has shape {tuple(bias.shape)}, expected "
                         f"({w.shape[1]},)")
    kw = dict(block_m=block_m, c_block=c_block)
    if s.device.type == "cpu":
        return gather_spike_matmul_plain(s, w, bias, **kw)
    if s.device.type != "cuda":
        raise ValueError(f"gather_spike_matmul runs on CPU or CUDA tensors, "
                         f"not {s.device.type}")
    return gather_spike_matmul_cuda(s, w, bias, **kw)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    from repro_torch.kernels import _build
    lib = _build.load("gather_spike_matmul")
    if lib.gather_spike_matmul_forward.argtypes is None:
        lib.gather_spike_matmul_forward.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.gather_spike_matmul_forward.restype = ctypes.c_int
        lib.quant_gather_spike_matmul_forward.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.quant_gather_spike_matmul_forward.restype = ctypes.c_int
        lib.gather_spike_matmul_error.argtypes = [ctypes.c_int]
        lib.gather_spike_matmul_error.restype = ctypes.c_char_p
    return lib


def stage_rows(s: torch.Tensor, block_m: int):
    """The plain version of the CUDA stagings' schedule (:func:`gather_stage`,
    :func:`quant_stage`), which the card's order and occupancies are held
    to bitwise: (order (Mp,) int64, sorted occupancies (Mp,) int32) — each
    row's occupancy (its non-zeros), padded with empty rows to a multiple
    of ``block_m`` and sorted stably. A group's capacity, min(pow2ceil(its
    largest occupancy), padded width), is its last sorted occupancy's, as
    :func:`build_schedule` has it."""
    occ = pad_to_multiple(torch.count_nonzero(s, dim=1).int(), 0, block_m)
    sorted_occ, order = torch.sort(occ, stable=True)
    return order, sorted_occ


def _check_gather_operands(s, w, bias):
    if s.dtype not in _DTYPES or w.dtype != s.dtype:
        raise ValueError(f"gather_spike_matmul kernel takes s and w of one "
                         f"dtype, float32 or bfloat16, got {s.dtype} and "
                         f"{w.dtype}")
    operands = (s, w) if bias is None else (s, w, bias)
    for a in operands:
        if a.device != s.device:
            raise ValueError("all gather_spike_matmul operands must be on "
                             "one device")
        if not a.is_contiguous():
            raise ValueError("gather_spike_matmul kernel takes contiguous "
                             "operands")


def _gather_forward(what: int, s, w=None, b32=None, ws=None, out=None,
                    mp: int = 0):
    m, k = s.shape
    lib = _library()
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    rc = lib.gather_spike_matmul_forward(
        what, _DTYPES[s.dtype], s.data_ptr(), ptr(w), ptr(b32), ws.data_ptr(),
        ptr(out), m, k, 0 if w is None else w.shape[1], mp,
        torch.cuda.current_stream(s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_spike_matmul kernel launch failed: "
                           f"{lib.gather_spike_matmul_error(rc).decode()}")


def gather_spike_matmul_cuda(s: torch.Tensor, w: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             block_m: int = 128, c_block: int = 128
                             ) -> torch.Tensor:
    """Launch the CUDA staging and product on PyTorch's current stream, in
    one call, reading nothing back. s and w share one dtype (float32 or
    bfloat16), which the output takes, and are contiguous. ``block_m``
    pads the staged rows to whole groups; ``c_block`` is the plain
    version's chunk, on which the kernel's sums do not depend."""
    _check_gather_operands(s, w, bias)
    m, n = s.shape[0], w.shape[1]
    out = torch.empty((m, n), dtype=s.dtype, device=s.device)
    if out.numel() == 0:
        return out
    ws, mp = _workspace(s, min(block_m, m))
    b32 = None if bias is None else bias.float().contiguous()
    _gather_forward(2, s, w, b32, ws, out, mp)
    LAUNCHES["gather_stage"] += 1
    LAUNCHES["gather_spike_matmul"] += 1
    return out


def gather_stage(s: torch.Tensor, block_m: int):
    """The CUDA staging of the gather product alone, on PyTorch's current
    stream and read back never. Returns (order (Mp,) int64, sorted
    occupancies (Mp,) int32, ones (M,) int32 — 1 where every non-zero of
    the row is 1 — and the workspace holding them and each row's live
    bits), the order and occupancies equal to :func:`stage_rows` on ``s``
    bitwise."""
    _check_gather_operands(s, s, None)
    m, k = s.shape
    ws, mp = _workspace(s, min(block_m, m))
    _gather_forward(0, s, ws=ws, mp=mp)
    LAUNCHES["gather_stage"] += 1
    at = 16 * mp + 4 * m * -(-k // 32)
    return (ws[:8 * mp].view(torch.int64),
            ws[8 * mp:12 * mp].view(torch.int32),
            ws[at:at + 4 * m].view(torch.int32), ws)


def launch_gather(s, w, bias, staged, *, out: torch.Tensor) -> torch.Tensor:
    """The product kernel alone, into ``out``, on operands
    :func:`gather_spike_matmul_cuda` takes and the workspace
    :func:`gather_stage` staged."""
    order, _, _, ws = staged
    b32 = None if bias is None else bias.float().contiguous()
    _gather_forward(1, s, w, b32, ws, out, order.numel())
    LAUNCHES["gather_spike_matmul"] += 1
    return out


# ---------------------------------------------------------------------------
# the quantized decoded product (``quant_gather_spike_matmul``)
# ---------------------------------------------------------------------------


def quant_gather_spike_matmul_plain(s: torch.Tensor, qw: torch.Tensor,
                                    scale: torch.Tensor,
                                    bias: Optional[torch.Tensor] = None, *,
                                    counts: bool = False,
                                    out_dtype: torch.dtype = torch.float32,
                                    block_m: int = 128, c_block: int = 128
                                    ) -> torch.Tensor:
    """Plain version of the kernel, through the JAX staging: the lanes'
    rows sorted into groups, each group's live slots summed in int32 up
    to its capacity (value x code row), the sums un-permuted, then
    ``spike_matmul.quant_epilogue``, rounded once to ``out_dtype``."""
    from repro_torch.kernels.spike_matmul import quant_epilogue, quant_lanes
    m, k = s.shape
    block_m, c_block = min(block_m, m), min(c_block, k)
    lanes = quant_lanes(s, counts)
    idx, vals, caps2d, order, _ = _stage(lanes, block_m, c_block, None)
    n_slots = int(caps2d.max()) if caps2d.numel() else 0
    codes = qw.to(torch.int32)
    acc = torch.zeros((idx.shape[0], qw.shape[1]), dtype=torch.int32,
                      device=s.device)
    for i in range(n_slots):
        acc += vals[:, i, None].to(torch.int32) * codes[idx[:, i].long()]
    y = torch.empty_like(acc)
    y[order] = acc
    return quant_epilogue(y[:m], scale, bias).to(out_dtype)


def quant_gather_spike_matmul(s: torch.Tensor, qw: torch.Tensor,
                              scale: torch.Tensor,
                              bias: Optional[torch.Tensor] = None, *,
                              counts: bool = False,
                              out_dtype: torch.dtype = torch.float32,
                              block_m: int = 128, c_block: int = 128
                              ) -> torch.Tensor:
    """y = (s @ qw) * scale (+ bias) -> (M, N) in ``out_dtype`` through the
    decoded datapath. s: (M, K) {0,1} spikes, or with ``counts``
    non-negative integer counts, in any dtype; qw: (K, N) int8 codes;
    scale, bias: (N,)."""
    from repro_torch.kernels.spike_matmul import _check_quant
    _check_quant("quant_gather_spike_matmul", s, qw, scale, bias)
    kw = dict(counts=counts, out_dtype=out_dtype, block_m=block_m,
              c_block=c_block)
    if s.device.type == "cpu":
        return quant_gather_spike_matmul_plain(s, qw, scale, bias, **kw)
    if s.device.type != "cuda":
        raise ValueError(f"quant_gather_spike_matmul runs on CPU or CUDA "
                         f"tensors, not {s.device.type}")
    return quant_gather_spike_matmul_cuda(s, qw, scale, bias, **kw)


# The CUDA product's grain (``csrc/gather_spike_matmul.cu``): sorted rows a
# block (QBM), lanes an mma k-step (KSTEP), and rows a chunk of its
# staging's counting sort (CHUNK).
QUANT_BLOCK_ROWS = 128
QUANT_KSTEP = 32
STAGE_CHUNK = 1024


def lane_values(s: torch.Tensor, counts: bool) -> torch.Tensor:
    """The staging kernel's cast of ``s`` to its lanes, in plain PyTorch:
    truncation toward zero to int32; a spike lane keeps the low byte
    (int8). Equals ``spike_matmul.quant_lanes`` on every value in the
    lane type's range."""
    x = torch.trunc(s.float()) if s.is_floating_point() else s
    x = x.to(torch.int32)
    return x if counts else x.to(torch.int8)


def lane_planes(lo: int, hi: int):
    """(planes, unsigned) the CUDA product splits lanes in [lo, hi] into:
    one unsigned byte plane if every lane lies in [0, 255]; else the
    fewest planes P with [lo, hi] inside [-2^(8P-1), 2^(8P-1)), the top
    one signed and the lower ones unsigned."""
    lo, hi = min(int(lo), 0), max(int(hi), 0)
    if hi <= 0xFF and lo == 0:
        return 1, True
    mag = max(hi, -lo - 1)
    for planes in (1, 2, 3):
        if mag < 1 << (8 * planes - 1):
            return planes, False
    return 4, False


def split_planes(lanes: torch.Tensor, planes: int, unsigned: bool):
    """Integer lanes -> ``planes`` int32 tensors, the byte planes the
    kernel stages: plane p holds byte p of the lane, unsigned below the
    top plane; the top one is signed (unsigned with ``unsigned``)."""
    x = lanes.to(torch.int32)
    out = [(x >> (8 * p)) & 0xFF for p in range(planes)]
    if not unsigned:
        out[-1] = (out[-1] ^ 0x80) - 0x80
    return out


def join_planes(products):
    """The planes' int32 products (plane 0 first) combined as the kernel
    does, by Horner's rule from the top plane: sum_p 256^p products[p]
    modulo 2^32, as int32."""
    acc = products[-1].long()
    for prod in reversed(products[:-1]):
        acc = acc * 256 + prod.long()
    return acc.to(torch.int32)


def _workspace(s: torch.Tensor, block_m: int):
    """(the staging's workspace, Mp) for ``s`` padded to ``block_m`` rows:
    the order (Mp int64), then int32 the sorted occupancies and the
    occupancies (Mp each), the live bits (M x ceil(K / 32)), a fact word a
    row (#4: every live value is 1; #5's counts: the value range) and the
    sort's histograms (ceil(Mp / STAGE_CHUNK) x (K + 1)), as ``csrc``
    lays it out (``Layout``)."""
    m, k = s.shape
    mp = -(-m // block_m) * block_m
    nbytes = (16 * mp + 4 * m * (-(-k // 32) + 1)
              + 4 * -(-mp // STAGE_CHUNK) * (k + 1))
    return torch.empty(nbytes, dtype=torch.uint8, device=s.device), mp


def _forward(lib, what: int, s, code, counts, qw=None, sc=None, b32=None,
             ws=None, out=None, n: int = 0, mp: int = 0):
    m, k = s.shape
    stream = torch.cuda.current_stream(s.device).cuda_stream
    out_code = 0 if out is None else _DTYPES[out.dtype]
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    rc = lib.quant_gather_spike_matmul_forward(
        what, code, int(counts), out_code, s.data_ptr(), ptr(qw), ptr(sc),
        ptr(b32), ws.data_ptr(), ptr(out), m, k, n, mp, stream)
    if rc != 0:
        raise RuntimeError(f"quant_gather_spike_matmul kernel launch failed: "
                           f"{lib.gather_spike_matmul_error(rc).decode()}")


def quant_stage(s: torch.Tensor, block_m: int, counts: bool):
    """The CUDA staging of the quantized product alone, on PyTorch's
    current stream and read back never. Returns (order (Mp,) int64,
    sorted occupancies (Mp,) int32, the workspace holding them and each
    row's live bits and value range), the order and occupancies equal to
    :func:`stage_rows` on the lanes bitwise, not on ``s`` (a value in
    (-1, 1) casts to a dark lane)."""
    s, code = lane_operand(s, counts)
    ws, mp = _workspace(s, block_m)
    _forward(_library(), 0, s, code, counts, ws=ws, mp=mp)
    LAUNCHES["quant_gather_stage"] += 1
    return (ws[:8 * mp].view(torch.int64),
            ws[8 * mp:12 * mp].view(torch.int32), ws)


def quant_gather_spike_matmul_cuda(s: torch.Tensor, qw: torch.Tensor,
                                   scale: torch.Tensor,
                                   bias: Optional[torch.Tensor] = None, *,
                                   counts: bool = False,
                                   out_dtype: torch.dtype = torch.float32,
                                   block_m: int = 128, c_block: int = 128
                                   ) -> torch.Tensor:
    """Launch the CUDA staging and product on PyTorch's current stream, in
    one call: ``s`` in fp32 or bf16 as it comes (any other dtype cast to
    its lanes, int8, or int32 with ``counts``), int8 codes, fp32 scale and
    bias; the output in ``out_dtype`` (float32 or bfloat16). ``c_block``
    is the plain version's chunk; the kernel's sums do not depend on it."""
    s, code, qw, sc, b32, _ = quant_operands(
        "quant_gather_spike_matmul", s, qw, scale, bias, counts, out_dtype)
    m, k = s.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=s.device)
    if out.numel() == 0:
        return out
    ws, mp = _workspace(s, min(block_m, m))
    _forward(_library(), 2, s, code, counts, qw, sc, b32, ws, out, n, mp)
    LAUNCHES["quant_gather_stage"] += 1
    LAUNCHES["quant_gather_spike_matmul"] += 1
    return out


def launch_quant_gather(s, qw, sc, b32, staged, *, counts: bool,
                        out: torch.Tensor) -> torch.Tensor:
    """The product kernel alone, into ``out``, on operands
    :func:`quant_gather_spike_matmul_cuda` lays out and the workspace
    :func:`quant_stage` staged."""
    s, code = lane_operand(s, counts)
    order, _, ws = staged
    _forward(_library(), 1, s, code, counts, qw, sc, b32, ws, out,
             qw.shape[1], order.numel())
    LAUNCHES["quant_gather_spike_matmul"] += 1
    return out
