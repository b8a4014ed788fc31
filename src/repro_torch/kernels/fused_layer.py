"""Fused whole-layer step — the layer program of the dual-engine overlay.

Port of ``repro.kernels.fused_layer`` for the fused and the pipelined
schedule (``pipeline=True``: the TPU grid's timestep wavefront, one
timestep at a time with the LIF membranes carried across T) and both
epilogue families:

* ``bn`` — the vision family's eval layer, with either projection
  datapath: the L-block tile skip (``sparse='tile'``) or the decoded
  gather (``sparse='decoded'``: the q/k/v projections contract each
  row's live spikes in ascending k, in chunks of ``c_block`` compacted
  slots under per-L-block pow2 capacities, staged by
  ``spike_decode.slab_decode``; wo, up and down keep the L-block tile
  skip, as in JAX);
* ``rope`` — the token family's layer: q/k/v projections of the analog
  ln1 output, RoPE on q and k, causal (or full) binarized attention, wo
  + residual, the ln2 rmsnorm, an up projection of the analog ln2 output,
  LIF and down + residual, with no BN. ``sparse='decoded'`` degenerates
  to the tile skip here, as in JAX: the projection input is analog.

Three functions of one layer:

* :func:`reference_layer` — the sequential oracle, term for term the
  JAX ``reference_layer``;
* :func:`fused_layer_plain` — the plain PyTorch version of the kernel:
  the same arithmetic as the CUDA kernel, plus the ``(H, 8, n_l_blocks)``
  map of executed sub-blocks per (head, phase, L-block) with the TPU
  kernel's predicates (for decoded q/k/v: executed gather chunks);
  :func:`fused_layer_pipeline_plain` the pipelined one: a loop over t
  that runs one timestep of the layer at a time, carries each membrane
  to the next timestep and adds each timestep's executed sub-blocks;
* :func:`fused_layer` — the wrapper: CPU tensors take the plain version,
  CUDA tensors launch ``csrc/fused_layer.cu`` or raise: through
  :func:`fused_layer_cuda` launch A (two kernels: the q/k/v projections
  per (w3 column slice, row group), then the attention per (query block,
  head, (t, b)), the spike bits between them in a device scratch) and
  launch B (three kernels, wo, up and down, each over (64-row, 64-column)
  tiles of the flattened (b, l) rows for up to four timesteps at once,
  the rope family's ln2 a fourth between wo and up; the input neuron's
  and the hidden spikes as bits in a device scratch); with
  ``pipeline=True`` through :func:`fused_layer_pipeline_cuda` the same
  launches once a timestep, the membranes moving between them through
  device scratch.

Analog scores (``binarize_scores=False``, Spikformer's raw SSA, which
JAX's kernel takes at the kernel API; no model path reaches the layer
program with them, as its eligibility requires binarized scores): the
scores are ``fl(count * scale)``, every key block is live for the score
phase, the context is summed over the keys in ascending order, one fp32
add a term (``fused_ssa.analog_context``), and wo, whose left operand is
then that analog context, is summed in ascending k on CUDA cores
(:func:`_seq_matmul`), so the kernel and the plain version agree
bitwise; against JAX's ``reference_layer``, which sums both in XLA's
order, they agree exactly wherever those sums are exact (power-of-two
scales and dyadic weights) and within a tolerance elsewhere.

Rounding rules shared by the plain version and the kernel: projections
accumulate in fp32 and are cast to the activation dtype before the
epilogue; BN runs in fp32 as ``fma32((y - mean) * inv_std, scale,
bias)`` with the inverse std from :func:`_inv_rows` (``torch.rsqrt(var
+ eps)`` per channel, computed once); RoPE is ``nn.rope_rotate``; the
residual adds in the activation dtype; LIF runs in the activation dtype.
The rope family adds two rules of its own, since its analog sums are
exact in no order:

* its two analog products (q/k/v of ln1, up of ln2) are summed in
  ascending k, one fp32 product and one fp32 sum a term
  (:func:`_seq_matmul`); the kernel runs them on CUDA cores in that
  order. The spike and count products (wo, down) are exact in any order
  on integer codes and dyadic weights and keep ``@``;
* ln2 (:func:`_rms_plain`) sums the squares as a pairwise tree over D
  zero-padded to a power of two (element i meets i + P/2, then i + P/4,
  ...) and takes its rsqrt as a float64 ``1 / sqrt`` rounded once. The
  oracle keeps ``nn.rmsnorm`` (mean, ``torch.rsqrt``), so the plain
  version and the oracle differ within a stated tolerance, and the
  oracle and JAX by the rsqrt gap of ``models/nn``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.spiking import SpikingConfig, lif_scan, lif_step
from repro_torch.kernels.fused_ssa import (analog_context, analog_scores,
                                           binary_scores, reference_bundle,
                                           rope_heads)
from repro_torch.kernels.fused_ssa import seq_matmul as _seq_matmul
from repro_torch.models.nn import bn_affine, rmsnorm

FAMILIES = ("bn", "rope")
# per-head phases of the layer program: three sparse projections, the
# two binary-engine phases, then the post-attention sparse phases
LAYER_PHASES = ("q", "k", "v", "qkt", "qktv", "wo", "up", "down")
N_PHASES = len(LAYER_PHASES)

# kernel launches on the card, by variant (bn tile, bn decoded, rope;
# fused or pipelined; binarized or analog scores, ``_analog``): each call
# of the fused CUDA layer program launches launch A's project_phase and
# attend_phase, then launch B's wo, up and down kernels (the rope family
# its ln2 kernel too), and counts every one; the pipelined one launches
# them once a timestep, T times as many a call
LAUNCHES = {f"fused_layer{sched}{variant}{scores}": 0
            for sched in ("", "_pipeline")
            for variant in ("", "_decoded", "_rope")
            for scores in ("", "_analog")}
LAUNCHES_PER_CALL = {"bn": 5, "rope": 6}

# shape limits of the CUDA kernel (csrc/fused_layer.cu). Launch A keeps
# the spike bits in device memory (:func:`bits_words`), so it takes any L;
# a row's q or k bits are at most four 32-bit words (head_dim <= 128), and
# a block holds its w3 column slice for all of D in shared memory
# (:func:`smem_a`, :func:`column_width`). Launch B holds a block's
# timesteps in groups and its spike bits and flags in device memory
# (:func:`spike_words`, :func:`flag_words`): it takes any T, number of
# heads, D and F
LAUNCH_B_SETS = 4              # launch B: timesteps a fused block holds at once
MA = 64                        # launch A: flattened (b, l) rows of a tile
KCA_BYTES = 256                # launch A: a staged slab chunk's row
SA = 3                         # launch A: slab chunks in flight
CW_MAX = 128                   # launch A: columns of a block's w3 slice
MAX_HEAD_DIM = 128
SMEM_LIMIT = 232448 - 1024     # per block, less launch A's static arrays


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_variant(family, sparse):
    if family not in FAMILIES:
        raise ValueError(f"unknown fused-layer family {family!r} "
                         f"(expected bn|rope)")
    if sparse not in ("tile", "decoded"):
        raise ValueError(f"unknown fused-layer sparse path {sparse!r}")


def _lif(u: torch.Tensor, decay: float, v_th: float, soft_reset: bool):
    mem = torch.zeros_like(u[0])
    out = []
    for x in u:
        mem, s = lif_step(mem, x, decay=decay, v_th=v_th,
                          soft_reset=soft_reset)
        out.append(s)
    return torch.stack(out)


def _inv_rows(aux: torch.Tensor, eps: float) -> torch.Tensor:
    """BN rows [mean, var, scale, bias] -> [mean, inv_std, scale, bias]."""
    aux = aux.float().clone()
    aux[..., 1, :] = torch.rsqrt(aux[..., 1, :] + eps)
    return aux


def _block_any(u: torch.Tensor, l_block: int, groups: int = 1
               ) -> torch.Tensor:
    """(T, B, L, C) -> (T, B, groups, n_l_blocks): any non-zero entry per
    L-block in each of ``groups`` equal channel slices."""
    t, b, l, c = u.shape
    nlb = -(-l // l_block)
    m = F.pad((u != 0).to(torch.uint8), (0, 0, 0, nlb * l_block - l))
    m = m.reshape(t, b, nlb, l_block, groups, c // groups)
    return m.amax(dim=(3, 5)).transpose(2, 3).bool()


def _rms_plain(x1: torch.Tensor, scale: torch.Tensor, eps: float
               ) -> torch.Tensor:
    """The rope kernel's ln2: sum of squares as a pairwise tree over D
    zero-padded to a power of two, the mean, a float64 ``1 / sqrt``
    rounded once, then ``(x * rsqrt) * scale`` in the activation dtype."""
    x32 = x1.float()
    d = x32.shape[-1]
    v = F.pad(x32 * x32, (0, (1 << (d - 1).bit_length()) - d))
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    var = v / d + torch.tensor(eps, dtype=torch.float32)
    rs = (1.0 / torch.sqrt(var.double())).float()
    return (x32 * rs * scale.float()).to(x1.dtype)


def _decoded_projections(s, w3, l_block, c_block):
    """The decoded q/k/v projections: for each row, the sum over its live
    spikes in ascending k (``spike_decode.gather_sum``, the kernel's
    order), as fp32 (3, T, B, L, H*hd); and the executed gather chunks
    per (T, B, L-block): chunk ci runs when ci * c_block is below the
    L-block's capacity."""
    from repro_torch.kernels.spike_decode import gather_sum, slab_decode
    idx, vals, caps, c_block = slab_decode(s, l_block=l_block,
                                           c_block=c_block)
    n_slots = int(caps.max()) if caps.numel() else 0
    cur = torch.stack([gather_sum(idx, vals, w, n_slots).transpose(0, 1)
                       for w in w3])
    chunks = -(-caps.transpose(0, 1) // c_block)
    return cur, chunks


def fused_layer_plain(x, s, w3, wo, w1, w2, scales, auxp, auxo, aux1, aux2,
                      delta, *, decay: float, v_th: float, soft_reset: bool,
                      **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel (see :func:`_layer_plain`): each LIF
    runs over all T at once."""
    def lif(name, u):
        return _lif(u, decay, v_th, soft_reset)
    return _layer_plain(x, s, w3, wo, w1, w2, scales, auxp, auxo, aux1, aux2,
                        delta, lif=lif, **kw)


def fused_layer_pipeline_plain(x, s, w3, wo, w1, w2, scales, auxp, auxo,
                               aux1, aux2, delta, *, decay: float,
                               v_th: float, soft_reset: bool, **kw
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the pipelined kernel, as the TPU's (B, T, 8, H)
    grid runs it: a loop over t, each step one timestep of the whole
    layer (:func:`_layer_plain` on the timestep's x and s) whose LIF
    neurons (q, k, v, the input neuron, the MLP hidden layer) take one
    step from the membrane the previous timestep left, zero at t = 0;
    each timestep's executed sub-blocks are added to the counts. Equal
    to :func:`fused_layer_plain` bitwise, outputs and counts."""
    mem = {}

    def lif(name, u):                   # u: (1, ...) one timestep
        m0 = mem.get(name, torch.zeros_like(u[0]))
        mem[name], spikes = lif_step(m0, u[0], decay=decay, v_th=v_th,
                                     soft_reset=soft_reset)
        return spikes[None]
    outs, counts = [], 0
    for t in range(x.shape[0]):
        out, cnt = _layer_plain(x[t:t + 1], s[t:t + 1], w3, wo, w1, w2,
                                scales, auxp, auxo, aux1, aux2, delta,
                                lif=lif, **kw)
        outs.append(out)
        counts = counts + cnt
    return torch.cat(outs), counts


def _layer_plain(x, s, w3, wo, w1, w2, scales, auxp, auxo, aux1, aux2,
                 delta, *, lif, num_heads: int, head_dim: int, scale: float,
                 l_block: int, decoded: bool = False, c_block: int = 128,
                 family: str = "bn", causal: bool = False,
                 binarize_scores: bool = True, norm_eps: float = 1e-6
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's arithmetic over the timesteps of x and s, with
    ``lif(name, u)`` the spikes of the LIF neuron ``name`` (q, k, v, s2,
    hid) on currents u. The bn aux rows carry the inverse std
    (:func:`_inv_rows`); the rope family reads the (2, L, hd/2) cos / sin
    table from ``auxp`` and the ln2 scale from ``auxo`` and ignores
    ``aux1`` / ``aux2``. Skipped sub-blocks contribute exact zeros, so
    the output is the dense composition (with ``decoded``, the q/k/v
    projections are summed in the decoded kernel's order instead); the
    counts follow the kernel's predicates: a projection / wo / up / down
    sub-block runs when its input rows of the L-block are not all zero, a
    score block when its key rows are not all dark (or delta <= 0, or
    the scores are analog: every block), a context block when
    additionally its value rows are not all dark; a decoded projection
    counts its executed gather chunks. Analog scores: the context and wo
    are summed in the kernel's order (:func:`analog_context`,
    :func:`_seq_matmul`)."""
    t, b, l, d = x.shape
    heads, hd = num_heads, head_dim
    dt = x.dtype
    sc3, sco, sc1, sc2 = scales

    def lin(u, w, sc):
        return ((u.float() @ w.float()) * sc.float()).to(dt)

    def bn(u, rows):
        return bn_affine(u.float(), rows[0], rows[1], rows[2], rows[3]
                         ).to(dt)

    def per_head(u):                                  # -> (T, B, H, L, c)
        return u.reshape(t, b, l, heads, -1).transpose(2, 3)

    def count(live):                                  # (T, B, G, nlb)
        return live.sum(dim=(0, 1)).expand(heads, -1)

    def cols(live):                                   # blocks -> columns
        return live.repeat_interleave(l_block, dim=-1)[..., None, :l]

    rope = family == "rope"
    if decoded:
        cur, chunks = _decoded_projections(s, w3, l_block, c_block)
        proj = [(cur[j] * sc3[j].float()).to(dt) for j in range(3)]
        proj_counts = count(chunks[:, :, None])
    elif rope:
        proj = [(_seq_matmul(s, w3[j]) * sc3[j].float()).to(dt)
                for j in range(3)]
        proj = [rope_heads(proj[0], auxp, heads),
                rope_heads(proj[1], auxp, heads), proj[2]]
        proj_counts = count(_block_any(s, l_block))
    else:
        proj = [bn(lin(s, w3[j], sc3[j]), auxp[j]) for j in range(3)]
        proj_counts = count(_block_any(s, l_block))
    if decoded:
        proj = [bn(proj[j], auxp[j]) for j in range(3)]
    q, k, v = (lif(name, u) for name, u in zip("qkv", proj))
    delta_t = torch.as_tensor(delta, dtype=torch.float32, device=x.device)
    k_live = _block_any(k, l_block, heads) | (delta_t <= 0) | \
        (not binarize_scores)
    c_live = k_live & _block_any(v, l_block, heads)
    if binarize_scores:
        a = binary_scores(per_head(q), per_head(k), scale, delta)
    else:
        a = analog_scores(per_head(q), per_head(k), scale)
    if causal:
        a = a.tril()
    a = a * cols(c_live)
    ctx = a @ per_head(v).float() if binarize_scores \
        else analog_context(a, per_head(v))
    ctx = ctx.to(dt).transpose(2, 3).reshape(t, b, l, heads * hd)
    # wo on an analog context is an analog sum: ascending k, as the kernel
    att = lin(ctx, wo, sco) if binarize_scores \
        else (_seq_matmul(ctx, wo) * sco.float()).to(dt)
    if rope:
        x1 = x + att
        s2 = _rms_plain(x1, auxo[0], norm_eps)
        hid = lif("hid", (_seq_matmul(s2, w1) * sc1.float()).to(dt))
        out = x1 + lin(hid, w2, sc2)
    else:
        x1 = x + bn(att, auxo)
        s2 = lif("s2", x1)
        hid = lif("hid", bn(lin(s2, w1, sc1), aux1))
        out = x1 + bn(lin(hid, w2, sc2), aux2)
    counts = torch.stack([
        proj_counts, proj_counts, proj_counts, count(k_live), count(c_live),
        count(_block_any(ctx, l_block, heads)),
        count(_block_any(s2, l_block)),
        count(_block_any(hid, l_block, heads))], dim=1)
    return out, counts.to(torch.int32)


def reference_layer(x, s, w3, wo, w1, w2, scales, auxp, auxo, aux1, aux2,
                    delta, scfg: SpikingConfig, *, family: str,
                    num_heads: int, head_dim: int, scale: float,
                    causal: bool = False, eps: float = 1e-5,
                    norm_eps: float = 1e-6) -> torch.Tensor:
    """The sequential oracle: the SSA bundle via ``reference_bundle``,
    then wo + epilogue + residual, the input LIF (bn) or ln2 (rope), and
    the spiking MLP, on the same raw operands the kernel sees (bn aux
    rows carry the variance; rope: the cos / sin table and the ln2
    scale)."""
    if scales is None:
        sc3 = sco = sc1 = sc2 = None
    else:
        sc3, sco, sc1, sc2 = scales

    def lin(u, w, sc):
        acc = u.float() @ w.float()
        if sc is not None:
            acc = acc * sc.float()
        return acc.to(u.dtype)

    def bn(u, aux):
        return bn_affine(u.float(), aux[0], torch.rsqrt(aux[1] + eps),
                         aux[2], aux[3]).to(x.dtype)

    ctx = reference_bundle(s, w3, sc3, auxp, delta, scfg, family=family,
                           num_heads=num_heads, head_dim=head_dim,
                           scale=scale, causal=causal, eps=eps)
    if family == "rope":
        x1 = x + lin(ctx, wo, sco)
        s2 = rmsnorm({"scale": auxo[0]}, x1, norm_eps)
        hid = lif_scan(lin(s2, w1, sc1), scfg)[0]
        return x1 + lin(hid, w2, sc2)
    x1 = x + bn(lin(ctx, wo, sco), auxo)
    s2 = lif_scan(x1, scfg)[0]
    hid = lif_scan(bn(lin(s2, w1, sc1), aux1), scfg)[0]
    return x1 + bn(lin(hid, w2, sc2), aux2)


def fused_layer(x: torch.Tensor, s: torch.Tensor, w3: torch.Tensor,
                wo: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                scales: Optional[Tuple[torch.Tensor, ...]],
                auxp: torch.Tensor, auxo: torch.Tensor,
                aux1: Optional[torch.Tensor], aux2: Optional[torch.Tensor],
                delta, *, family: str, num_heads: int, head_dim: int,
                scale: float, causal: bool = False, sparse: str = "tile",
                pipeline: bool = False, binarize_scores: bool = True,
                decay: float = 0.5, v_th: float = 1.0,
                soft_reset: bool = False, eps: float = 1e-5,
                norm_eps: float = 1e-6, l_block: int = 128,
                c_block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused whole-layer step (forward only), the signature of the JAX
    ``fused_layer``.

    x: (T, B, L, D) layer input (the residual stream); s: (T, B, L, D)
    ``LIF(x)`` spikes (bn) or the ln1-normed currents (rope); w3
    (3, D, H*hd), wo (H*hd, D), w1 (D, F), w2 (F, D) with F a multiple of
    ``num_heads``; scales: fp32 (scale3 (3, H*hd), scale_o (D,), scale_1
    (F,), scale_2 (D,)) or None. Family 'bn': auxp (3, 4, H*hd), auxo
    (4, D), aux1 (4, F), aux2 (4, D) BN rows [mean, var, scale, bias];
    family 'rope': auxp the (2, L, hd/2) [cos; sin] table, auxo the
    (1, D) ln2 scale, aux1 / aux2 ignored. ``sparse``: 'tile' or
    'decoded' (the q/k/v projection datapath; rope takes 'tile');
    ``l_block``: the L-block of the occupancy skips and decoded
    capacities; ``c_block``: the decoded chunk of compacted slots.

    ``pipeline``: the TPU kernel's per-timestep wavefront grid; outputs
    and counts are those of the fused schedule. ``binarize_scores=False``:
    analog attention scores (the module's notes give their sum orders).

    Returns (layer output (T, B, L, D) in the activation dtype, counts
    (H, 8, ceil(L / l_block)) int32 — executed sub-blocks per head,
    phase (:data:`LAYER_PHASES`) and L-block)."""
    _check_variant(family, sparse)
    args, kw = prepare(x, s, w3, wo, w1, w2, scales, auxp, auxo, aux1, aux2,
                       delta, num_heads=num_heads, head_dim=head_dim,
                       scale=scale, decay=decay, v_th=v_th,
                       soft_reset=soft_reset, eps=eps, l_block=l_block,
                       sparse=sparse, c_block=c_block, family=family,
                       causal=causal, binarize_scores=binarize_scores,
                       norm_eps=norm_eps)
    if x.device.type == "cpu":
        plain = fused_layer_pipeline_plain if pipeline else fused_layer_plain
        return plain(*args, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer runs on CPU or CUDA tensors, not "
                         f"{x.device.type}")
    launch = fused_layer_pipeline_cuda if pipeline else fused_layer_cuda
    return launch(*args, **kw)


def prepare(x, s, w3, wo, w1, w2, scales, auxp, auxo, aux1, aux2, delta, *,
            num_heads, head_dim, scale, decay, v_th, soft_reset, eps,
            l_block, sparse="tile", c_block=128, family="bn", causal=False,
            binarize_scores=True, norm_eps=1e-6):
    """Checks the operands of :func:`fused_layer` and returns the
    ``(args, kwargs)`` that :func:`fused_layer_plain` and
    :func:`fused_layer_cuda` both take: fp32 scales (ones for None), BN
    rows with the inverse std (bn) or the fp32 table and ln2 scale with
    ``aux1`` / ``aux2`` None (rope), delta as a 1-element fp32 tensor,
    ``l_block`` clipped to L, ``decoded`` for ``sparse='decoded'`` on the
    bn family and ``c_block`` clipped to D (as ``slab_decode`` clips
    it)."""
    t, b, l, d = x.shape
    q_dim = num_heads * head_dim
    ff = w1.shape[1]
    shapes = {"s": (s.shape, x.shape), "w3": (w3.shape, (3, d, q_dim)),
              "wo": (wo.shape, (q_dim, d)), "w2": (w2.shape, (ff, d)),
              "w1": (w1.shape, (d, ff))}
    if family == "bn":
        shapes.update(auxp=(auxp.shape, (3, 4, q_dim)),
                      auxo=(auxo.shape, (4, d)), aux1=(aux1.shape, (4, ff)),
                      aux2=(aux2.shape, (4, d)))
    else:
        if head_dim % 2:
            raise ValueError("the rope family takes an even head_dim")
        shapes.update(auxp=(auxp.shape, (2, l, head_dim // 2)),
                      auxo=(auxo.shape, (1, d)))
    for name, (got, want) in shapes.items():
        if tuple(got) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(got)}, expected "
                             f"{tuple(want)}")
    if ff % num_heads:
        raise ValueError("pad d_ff to a multiple of num_heads")
    dev = x.device
    if scales is None:
        scales = (torch.ones((3, q_dim), device=dev),
                  torch.ones((d,), device=dev), torch.ones((ff,), device=dev),
                  torch.ones((d,), device=dev))
    scales = tuple(a.float().contiguous() for a in scales)
    if family == "bn":
        auxp, auxo, aux1, aux2 = (_inv_rows(a, eps) for a in
                                  (auxp, auxo, aux1, aux2))
    else:
        auxp, auxo, aux1, aux2 = auxp.float(), auxo.float(), None, None
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev
                            ).reshape(1)
    kw = dict(num_heads=num_heads, head_dim=head_dim, scale=scale,
              decay=decay, v_th=v_th, soft_reset=soft_reset,
              l_block=max(1, min(l_block, l)),
              decoded=sparse == "decoded" and family == "bn",
              c_block=max(1, min(c_block, d)), family=family, causal=causal,
              binarize_scores=binarize_scores, norm_eps=norm_eps)
    return (x, s, w3, wo, w1, w2, scales, auxp, auxo, aux1, aux2, delta), kw


def _padded(n: int, elem_size: int) -> int:
    """A staged row of n elements padded to an odd number of 16-byte
    units (``padded`` in the CUDA source)."""
    return n + (16 // elem_size if (n * elem_size // 16) % 2 == 0
                else 32 // elem_size)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_a(elem_size: int, d: int, head_dim: int, cw: int,
           rope: bool = False) -> int:
    """Launch A's projection block's dynamic shared memory in bytes
    (``SmemP`` in the CUDA source, carved in this order) with a column
    slice ``cw`` wide: the slice of w3 for all D rows (the rope family's
    transposed in fp32), the ring of slab chunks, the rope family's
    scaled projections, the tile's q / k words and v masks, and two
    16-byte parameter vectors a column. Each name below is the offset
    where its region starts."""
    ngw = (cw // head_dim if cw >= head_dim else 1) * -(-head_dim // 32)
    ring = _align16(cw * (d + 4) * 4 if rope
                    else d * _padded(cw, elem_size) * elem_size)
    kca = KCA_BYTES // elem_size
    yproj = ring + SA * MA * _padded(kca, elem_size) * elem_size
    qkw = yproj + (MA * cw * 4 if rope else 0)
    return qkw + _align16(MA * ngw * 4) + cw * 2 * 4 + cw * 2 * 16


def column_widths(heads: int, head_dim: int) -> list:
    """The column slices launch A takes, widest first: whole (q/k/v, head)
    groups that tile the 3 H groups, or a pair slice of one group (a
    width dividing head_dim: half its columns from each half of the
    group), a multiple of 8 up to CW_MAX."""
    whole = [m * head_dim for m in range(1, 3 * heads + 1)
             if (3 * heads) % m == 0 and m * head_dim <= CW_MAX]
    pair = [cw for cw in range(8, head_dim, 8) if head_dim % cw == 0]
    return sorted(set(whole + pair), reverse=True)


@functools.lru_cache(maxsize=None)
def _fitting_width(elem_size: int, d: int, heads: int, head_dim: int,
                   rope: bool) -> int:
    """The widest column slice whose w3 rows fit one block's shared
    memory beside the slab ring (:func:`smem_a`), or 0 when none does.
    Cached: the wrapper asks on every launch."""
    for cw in column_widths(heads, head_dim):
        if smem_a(elem_size, d, head_dim, cw, rope) <= SMEM_LIMIT:
            return cw
    return 0


def column_width(elem_size: int, d: int, heads: int, head_dim: int,
                 rope: bool = False, what: str = "fused_layer") -> int:
    """The widest column slice whose w3 rows fit one block's shared
    memory beside the slab ring (:func:`smem_a`); raises ValueError when
    none does (a D too wide for an 8-column slice)."""
    cw = _fitting_width(elem_size, d, heads, head_dim, rope)
    if not cw:
        raise ValueError(f"{what} kernel holds a w3 column slice of all D "
                         f"rows in shared memory, got D={d}, "
                         f"head_dim={head_dim}")
    return cw


def bits_words(t: int, b: int, l: int, heads: int, head_dim: int,
               nlb: int) -> int:
    """int32 words of launch A's bit scratch (``BitsLayout`` in the CUDA
    source), per timestep: q and k bits (B, H, L, ceil(hd / 32)) each, v
    bits transposed (B, H, hd, ceil(L / 32)), the key and value L-block
    flags (B, H, n_l_blocks) each, the projection flags (B,
    n_l_blocks)."""
    hw, lw = -(-head_dim // 32), -(-l // 32)
    return t * (2 * b * heads * l * hw + b * heads * head_dim * lw
                + 2 * b * heads * nlb + b * nlb)


def spike_words(t: int, m: int, d: int, ff: int) -> int:
    """int32 words of launch B's spike bits, the input neuron's then the
    hidden layer's, chunk-major: (T, ceil(D / 64) or ceil(F / 64) pairs of
    words, B L rows rounded up to even, 2), a row's 64 columns of a
    K-chunk in one 8-byte pair, so a chunk of rows is contiguous; the
    pipelined kernel holds one timestep's."""
    return t * (m + m % 2) * 2 * (-(-d // 64) + -(-ff // 64))


def flag_words(t: int, b: int, nlb: int, heads: int) -> int:
    """int32 words of launch B's flags (``Flags`` in the CUDA source), every
    timestep's: a (t, b, L-block, head) whose context is live (set by
    launch A's attention) and one with a hidden spike, each (T, B, nlb,
    H), then a (t, b, L-block) with an input spike or a non-zero ln2
    output (T, B, nlb)."""
    return t * b * nlb * (2 * heads + 1)


def membrane_bytes(elem_size: int, t: int, b: int, l: int, d: int,
                   q_dim: int, ff: int, rope: bool = False) -> int:
    """Device-memory bytes the pipelined kernel moves for its membranes,
    beyond the fused kernel's traffic: each timestep writes the q/k/v,
    input-neuron (bn) and hidden membranes, and each timestep after the
    first reads them."""
    per_step = b * l * (3 * q_dim + (0 if rope else d) + ff) * elem_size
    return (2 * t - 1) * per_step


def _head_dim_taken(d: int, head_dim: int) -> bool:
    """A row's q or k bits in at most four words, 16-byte rows of D."""
    return head_dim <= MAX_HEAD_DIM and head_dim % 8 == 0 and d % 16 == 0


def launch_a_takes(elem_size: int, d: int, heads: int, head_dim: int, *,
                   rope: bool = False) -> bool:
    """Whether launch A (the layer program's first half, and the SSA
    bundle kernel) takes a layer of these widths: the bounds that
    :func:`check_launch_shapes` raises on. The engine routes a layer it
    does not take to the sequential composition, on every device, before
    any launch."""
    return (_head_dim_taken(d, head_dim)
            and _fitting_width(elem_size, d, heads, head_dim, rope) > 0)


def check_launch_shapes(elem_size: int, t: int, l: int, d: int, heads: int,
                        head_dim: int, nlb: int, *, rope: bool = False,
                        what: str = "fused_layer") -> None:
    """Raises ValueError for a shape that launch A does not take
    (:func:`launch_a_takes`); ``what`` names the kernel in the message.
    Launch A takes any T and L; launch B any T, number of heads, D and
    F."""
    if not _head_dim_taken(d, head_dim):
        raise ValueError(f"{what} kernel takes head_dim a multiple of 8 up "
                         f"to {MAX_HEAD_DIM} and D a multiple of 16, got "
                         f"head_dim={head_dim}, D={d}")
    column_width(elem_size, d, heads, head_dim, rope, what)


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 15
             + [ctypes.c_float] * 3 + [ctypes.c_int] + [ctypes.c_float]
             + [ctypes.c_int] * 15 + [ctypes.c_void_p] * 7)
# the fused entry adds launch B's two membrane scratch pointers, the
# pipelined one launch A's too
_FUSED_ARGTYPES = _ARGTYPES + [ctypes.c_void_p] * 2
_PIPELINE_ARGTYPES = _ARGTYPES + [ctypes.c_void_p] * 3


def _library():
    from repro_torch.kernels import _build
    lib = _build.load("fused_layer")
    if lib.fused_layer_forward.argtypes is None:
        lib.fused_layer_forward.argtypes = _FUSED_ARGTYPES + [ctypes.c_void_p]
        lib.fused_layer_forward.restype = ctypes.c_int
        lib.fused_layer_pipeline_forward.argtypes = \
            _PIPELINE_ARGTYPES + [ctypes.c_void_p]
        lib.fused_layer_pipeline_forward.restype = ctypes.c_int
        lib.fused_layer_error.argtypes = [ctypes.c_int]
        lib.fused_layer_error.restype = ctypes.c_char_p
    return lib


def fused_layer_cuda(x, s, w3, wo, w1, w2, scales, auxp, auxo, aux1, aux2,
                     delta, **kw):
    """Launch the CUDA layer program on PyTorch's current stream, on the
    operands :func:`prepare` returns; counted under ``fused_layer``,
    ``fused_layer_decoded`` (``decoded``) or ``fused_layer_rope``, with
    ``_analog`` appended for analog scores."""
    return _launch(False, x, s, w3, wo, w1, w2, scales, auxp, auxo, aux1,
                   aux2, delta, **kw)


def fused_layer_pipeline_cuda(x, s, w3, wo, w1, w2, scales, auxp, auxo,
                              aux1, aux2, delta, **kw):
    """Launch the pipelined CUDA layer program (#1d): launch A (two
    kernels) and launch B (three, rope four) once a timestep, A_0, B_0,
    A_1, B_1, ..., on PyTorch's current stream, with the membranes in
    device scratch between them; counted, T times
    :data:`LAUNCHES_PER_CALL` a call, under ``fused_layer_pipeline``,
    ``fused_layer_pipeline_decoded`` or ``fused_layer_pipeline_rope``."""
    return _launch(True, x, s, w3, wo, w1, w2, scales, auxp, auxo, aux1,
                   aux2, delta, **kw)


def _aligned(a: torch.Tensor) -> torch.Tensor:
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _launch(pipeline, x, s, w3, wo, w1, w2, scales, auxp, auxo, aux1, aux2,
            delta, *, num_heads, head_dim, scale, decay, v_th, soft_reset,
            l_block, decoded=False, c_block=128, family="bn", causal=False,
            binarize_scores=True, norm_eps=1e-6):
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    if x.dtype not in dtypes:
        raise ValueError(f"fused_layer kernel takes float32 or bfloat16, "
                         f"not {x.dtype}")
    rope = family == "rope"
    if rope:                    # unused by the kernel: any valid pointer
        aux1 = aux2 = auxo
    act = (x, s, w3, wo, w1, w2)
    f32 = (*scales, auxp, auxo, aux1, aux2, delta)
    for a in act + f32:
        if a.device != x.device:
            raise ValueError("all fused_layer operands must be on one device")
    for a in act:
        if a.dtype != x.dtype:
            raise ValueError("x, s and the weights must share one dtype")
    t, b, l, d = x.shape
    ff = w1.shape[1]
    nlb = -(-l // l_block)
    check_launch_shapes(x.element_size(), t, l, d, num_heads, head_dim, nlb,
                        rope=rope)
    # the kernels copy 16 bytes at a time: a view off a 16-byte boundary
    # is copied to fresh (aligned) storage
    act = tuple(_aligned(a) for a in act)
    f32 = tuple(a.contiguous() for a in f32)
    q_dim = num_heads * head_dim
    new = lambda *shape: torch.empty(shape, dtype=x.dtype,  # noqa: E731
                                     device=x.device)
    ctx = new(t, b, l, q_dim)
    # the rope family's ln2 output: every timestep (fused) or the launch
    # pair's one (pipelined)
    s2g = (new(b, l, d) if pipeline else torch.empty_like(act[0])) \
        if rope else ctx
    out = torch.empty_like(act[0])
    counts = torch.zeros((num_heads, N_PHASES, nlb), dtype=torch.int32,
                         device=x.device)
    # launch B's flag words (every timestep's) and spike bits (every
    # timestep's, or the pipelined launches' one; fully written before
    # they are read)
    flags = torch.zeros(flag_words(t, b, nlb, num_heads), dtype=torch.int32,
                        device=x.device)
    sbits = torch.empty(spike_words(1 if pipeline else t, b * l, d, ff),
                        dtype=torch.int32, device=x.device)
    # launch A's spike bits and count flags, every timestep's (the
    # pipelined launches take their timestep's sections)
    bits = torch.zeros(bits_words(t, b, l, num_heads, head_dim, nlb),
                       dtype=torch.int32, device=x.device)
    cw = column_width(x.element_size(), d, num_heads, head_dim, rope)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cp = -(-d // c_block) * c_block
    args = [dtypes[x.dtype], *(a.data_ptr() for a in act + f32),
            float(scale), float(decay), float(v_th), int(soft_reset),
            float(norm_eps), int(rope), int(causal), int(not binarize_scores),
            t, b, l, d, num_heads,
            head_dim, ff, l_block, int(decoded), c_block, cp, cw,
            bits.data_ptr(), ctx.data_ptr(), s2g.data_ptr(), out.data_ptr(),
            counts.data_ptr(), flags.data_ptr(), sbits.data_ptr()]
    if pipeline:
        # the membranes between launches (q/k/v, input neuron, hidden);
        # the first timestep does not read them
        scratch = (new(b, l, 3 * q_dim), new(b, l, d), new(b, l, ff))
        rc = lib.fused_layer_pipeline_forward(
            *args, *(a.data_ptr() for a in scratch), stream)
    else:
        # launch B's membranes between its groups of timesteps (input
        # neuron, hidden), when T takes more than one group
        scratch = (new(b, l, d), new(b, l, ff)) if t > LAUNCH_B_SETS else ()
        rc = lib.fused_layer_forward(*args, *(a.data_ptr() for a in scratch),
                                     *(None,) * (2 - len(scratch)), stream)
    if rc != 0:
        raise RuntimeError(f"fused_layer kernel launch failed: "
                           f"{lib.fused_layer_error(rc).decode()}")
    name = "fused_layer_pipeline" if pipeline else "fused_layer"
    name += "_rope" if rope else "_decoded" if decoded else ""
    name += "" if binarize_scores else "_analog"
    LAUNCHES[name] += LAUNCHES_PER_CALL[family] * (t if pipeline else 1)
    return out, counts
