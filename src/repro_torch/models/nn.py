"""Functional NN layers: those of the spiking vision models and the
token family (norms, RoPE, the MLP and its activations, the chunked
attention dataflows of the dense decoders, and the layer norms,
sinusoid positions and causal depthwise conv of the rwkv, hybrid and
encoder-decoder families).

Mirrors ``repro.models.nn``: params are nested dicts of tensors made by
``*_init`` functions from a ``torch.Generator``; activations keep the
JAX package's layouts at the public functions (NHWC images, HWIO conv
weights, ``(d_in, d_out)`` linear weights).

Two numerics rules keep the port bitwise with the jitted reference:

* :func:`fma32` — XLA contracts an fp32 ``a * b + c`` into one fused
  multiply-add (BN's affine, the binary-attention threshold). The port
  computes it as a float64 product plus a float64 sum, rounded once to
  fp32; the CUDA kernels use the same definition, so kernel and plain
  version agree by construction.
* the BN inverse std is ``torch.rsqrt(var + eps)``, computed once per
  channel. It differs from XLA's rsqrt by one or two ulp on about a
  third of inputs, which tests avoid by drawing variances where the two
  agree.

RoPE follows the jitted reference's contraction too: XLA computes
``x1 * cos - x2 * sin`` as ``fma(x1, cos, -(x2 * sin))`` and ``x2 * cos
+ x1 * sin`` as ``fma(x2, cos, x1 * sin)``. Its cos / sin table is
taken in float64 and rounded once, the same on every device; it differs
from XLA's fp32 cos / sin by one ulp on about 1% of entries, and
:func:`rmsnorm`'s rsqrt is the rsqrt gap above, so the token family is
held against JAX within a stated tolerance.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once (float64 product and sum)."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float32, device=a.device)
               .double() for v in (a, b, c))
    return (a * b + c).float()


def bn_affine(y32: torch.Tensor, mean, inv_std, scale, bias) -> torch.Tensor:
    """The eval BatchNorm affine on fp32 values: ``(y - mean) * inv_std``
    rounded, then ``* scale + bias`` as one fused multiply-add."""
    return fma32((y32 - mean) * inv_std, scale, bias)


class _MetaGenerator:
    """The generator of an init on the meta device: its draws are shapes
    only, so an abstract params tree allocates nothing."""
    device = torch.device("meta")

    def manual_seed(self, seed: int) -> "_MetaGenerator":
        return self


def generator(device: torch.device):
    """A ``torch.Generator`` on ``device``, or on the meta device a
    stand-in whose :func:`normal` draws allocate nothing."""
    if device.type == "meta":
        return _MetaGenerator()
    return torch.Generator(device=device)


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """fp32 normal draws on the generator's device, scaled and cast."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std).to(dtype)


def linear_init(gen, d_in: int, d_out: int, *, bias: bool = False,
                std=None, dtype=torch.bfloat16):
    std = 1.0 / math.sqrt(d_in) if std is None else std
    p = {"w": normal(gen, (d_in, d_out), std, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def linear(p, x: torch.Tensor, *, spikes: bool = False,
           counts: bool = False, analog: bool = False) -> torch.Tensor:
    """Linear layer in the activation dtype (fp32 accumulation).

    ``spikes=True`` marks a {0,1} spike input (``counts=True``: the
    integer counts binary attention emits; ``analog=True``: an analog
    attention context in their place); with an engine installed such
    call sites go through the sparse engine's dispatch
    (``core.engine.spike_linear``; a quantized dict ignores ``analog``).
    Otherwise this is the plain dense path, on a quantized dict the
    weight-only quantized reference (``dense_quant_linear``)."""
    if spikes:
        from repro_torch.core import engine as _engine  # lazy: no cycle
        if _engine.get_engine() is not None:
            return _engine.spike_linear(p, x, counts=counts, analog=analog)
    return linear_epilogue(p, linear_acc(p, x), x.dtype)


def linear_acc(p, x: torch.Tensor) -> torch.Tensor:
    """The dense path's fp32 accumulator (fp weights, or int8 / int4 codes
    cast to ``x.dtype``), before its epilogue; a row-split product's
    partial sum on a mesh (``parallel.spmd``)."""
    if "qw" in p:
        from repro_torch.core.engine import _unpacked_qw  # lazy: no cycle
        return x.float() @ _unpacked_qw(p, x.shape[-1]).to(x.dtype).float()
    return x.float() @ p["w"].float()


def linear_epilogue(p, acc: torch.Tensor, dtype) -> torch.Tensor:
    """The dense path's epilogue on an fp32 accumulator, rounded once to
    ``dtype``: int8 / int4 codes' per-output-channel scale (+ bias, one
    fused multiply-add, the jitted reference's contraction), or the fp
    cast then the bias. :func:`linear` and ``dense_quant_linear`` are
    ``linear_epilogue(p, linear_acc(p, x), x.dtype)``."""
    if "qw" in p:
        from repro_torch.kernels.spike_matmul import quant_epilogue
        return quant_epilogue(acc, p["scale"], p.get("b")).to(dtype)
    y = acc.to(dtype)
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype=torch.bfloat16):
    return {"scale": torch.ones((d,), dtype=dtype)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def layernorm_init(d: int, dtype=torch.bfloat16):
    return {"scale": torch.ones((d,), dtype=dtype),
            "bias": torch.zeros((d,), dtype=dtype)}


def _normalize(x32: torch.Tensor, eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) over the last axis, the variance the
    mean of the centred squares (as ``jnp.var``)."""
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    y = _normalize(x.float(), eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def groupnorm(p, x: torch.Tensor, groups: int, eps: float = 1e-5
              ) -> torch.Tensor:
    """GroupNorm over the last dim split into ``groups`` (RWKV's head
    norm)."""
    d = x.shape[-1]
    x32 = x.float().reshape(*x.shape[:-1], groups, d // groups)
    y = _normalize(x32, eps).reshape(*x.shape[:-1], d)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def embedding_init(gen, vocab: int, d: int, dtype=torch.bfloat16):
    return {"table": normal(gen, (vocab, d), 1.0 / math.sqrt(d), dtype)}


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ p["table"].to(x.dtype).float().t()


def mlp_init(gen, d_model: int, d_ff: int, *, gated: bool,
             dtype=torch.bfloat16):
    p = {"up": linear_init(gen, d_model, d_ff, dtype=dtype),
         "down": linear_init(gen, d_ff, d_model, dtype=dtype)}
    if gated:
        p["gate"] = linear_init(gen, d_model, d_ff, dtype=dtype)
    return p


def activation(name: str):
    """The MLP nonlinearity: 'silu', 'gelu' (the tanh approximation, as
    JAX's ``jax.nn.gelu`` defaults to) or 'relu2' (squared ReLU)."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.relu(x).square()
    raise ValueError(f"unknown activation {name}")


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated (``act(gate(x)) * up(x)``) or plain (``act(up(x))``) MLP."""
    h = linear(p["up"], x)
    if "gate" in p:
        h = activation(act)(linear(p["gate"], x)) * h
    else:
        h = activation(act)(h)
    return linear(p["down"], h)


# ---------------------------------------------------------------------------
# chunked attention of the dense decoders: the reference's jnp dataflows
# with its chunk sizes and masks, so each chunk's reductions cover the
# same entries. Scores and sums are fp32; outputs in q's dtype.
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _pad_to(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``dim`` up to ``size``."""
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - dim) + [0, pad]
    return F.pad(x, widths)


def _chunks(q, k, v, q_chunk: int, kv_chunk: int):
    """(q (B, nq, qc, KH, rep, D), k / v (B, nk, kc, KH, D), sizes)
    zero-padded to whole chunks."""
    b, lq, h, d = q.shape
    lk, kh = k.shape[1], k.shape[2]
    q_chunk, kv_chunk = min(q_chunk, lq), min(kv_chunk, lk)
    nq, nk = -(-lq // q_chunk), -(-lk // kv_chunk)
    qp = _pad_to(q, nq * q_chunk, 1).reshape(b, nq, q_chunk, kh, h // kh, d)
    kp = _pad_to(k, nk * kv_chunk, 1).reshape(b, nk, kv_chunk, kh, d)
    vp = _pad_to(v, nk * kv_chunk, 1).reshape(b, nk, kv_chunk, kh, d)
    return qp, kp, vp, q_chunk, kv_chunk


def _chunk_mask(qpos, kpos, lk: int, causal: bool, window, kvl):
    """(B or 1, qc, kc) bool: the keys each query of a chunk sees."""
    mask = (kpos < lk)[None, None, :].expand(1, qpos.shape[0], -1)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    if kvl is not None:
        mask = mask & (kpos[None, :] < kvl.reshape(-1, 1))[:, None, :]
    return mask


def _scores(q_blk: torch.Tensor, k_blk: torch.Tensor) -> torch.Tensor:
    """(B, qc, KH, rep, D) x (B, kc, KH, D) -> fp32 (B, qc, KH, rep, kc)."""
    return torch.einsum("bqgrd,bkgd->bqgrk", q_blk.float(), k_blk.float())


def _context(a: torch.Tensor, v_blk: torch.Tensor) -> torch.Tensor:
    """Weights ``a`` rounded to v's dtype, times v, summed in fp32."""
    return torch.einsum("bqgrk,bkgd->bqgrd", a.to(v_blk.dtype).float(),
                        v_blk.float())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, q_offset=0,
                    kv_valid_len=None, scale=None, q_chunk: int = 1024,
                    kv_chunk: int = 2048) -> torch.Tensor:
    """Online-softmax attention with GQA grouping.

    q: (B, Lq, H, D); k, v: (B, Lk, KH, D), H % KH == 0. ``q_offset``:
    absolute position of q[0]; ``kv_valid_len``: keys at or past it are
    masked (scalar or (B,)); ``window``: sliding-window width (None =
    full). Every kv chunk is visited, masked or not, as the reference's
    scan visits it."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qp, kp, vp, qc, kc = _chunks(q, k, v, q_chunk, kv_chunk)
    dev = q.device
    kvl = None if kv_valid_len is None else torch.as_tensor(kv_valid_len,
                                                            device=dev)
    base = torch.as_tensor(q_offset, device=dev)
    outs = []
    for qi in range(qp.shape[1]):
        q_blk = qp[:, qi]
        qpos = base + qi * qc + torch.arange(qc, device=dev)
        m = torch.full(q_blk.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=dev)
        l_sum = torch.zeros_like(m)
        acc = torch.zeros(q_blk.shape, dtype=torch.float32, device=dev)
        for ki in range(kp.shape[1]):
            kpos = ki * kc + torch.arange(kc, device=dev)
            s = _scores(q_blk, kp[:, ki]) * scale
            mask = _chunk_mask(qpos, kpos, lk, causal, window, kvl)
            s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + p.sum(-1)
            acc = acc * corr[..., None] + _context(p, vp[:, ki])
            m = m_new
        out = acc / torch.clamp(l_sum[..., None], min=1e-20)
        outs.append(out.to(q.dtype))
    out = torch.cat(outs, dim=1).reshape(b, -1, h, d)[:, :lq]
    return out


def banded_flash_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, window: int, scale=None,
                           q_chunk: int = 512) -> torch.Tensor:
    """Causal sliding-window self-attention (Lq == Lk, offset 0) with a
    static band: each q chunk reads only the ``min(Lpad, window +
    q_chunk)`` keys ending at its last query (the band's start clipped
    into the sequence padded to whole q chunks, Lpad), one softmax over
    the band.

    The reference bounds the band by Lk, not Lpad: where window <= Lk <
    window + q_chunk and Lk is no multiple of q_chunk, its last chunks'
    bands then start past keys their windows hold, and drop them
    (ROADMAP queue 3). Bounded by Lpad, the band holds every key a chunk
    sees; elsewhere the two bands are the same."""
    b, l, h, d = q.shape
    lk, kh = k.shape[1], k.shape[2]
    if l != lk:
        raise ValueError("banded attention is self-attention (Lq == Lk)")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q_chunk = min(q_chunk, l)
    nq = -(-l // q_chunk)
    lpad = nq * q_chunk
    band = min(lpad, window + q_chunk)
    qp = _pad_to(q, lpad, 1).reshape(b, nq, q_chunk, kh, h // kh, d)
    kp, vp = _pad_to(k, lpad, 1), _pad_to(v, lpad, 1)
    dev = q.device
    outs = []
    for qi in range(nq):
        q_start = qi * q_chunk
        start = min(max(q_start + q_chunk - band, 0), lpad - band)
        k_band = kp[:, start:start + band]
        v_band = vp[:, start:start + band]
        qpos = q_start + torch.arange(q_chunk, device=dev)
        kpos = start + torch.arange(band, device=dev)
        s = _scores(qp[:, qi], k_band) * scale
        mask = ((kpos[None, :] <= qpos[:, None])
                & (kpos[None, :] > qpos[:, None] - window)
                & (kpos < l)[None, :])
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        out = _context(p, v_band) / torch.clamp(p.sum(-1, keepdim=True),
                                                 min=1e-20)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(b, lpad, h, d)[:, :l]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, entry_pos, cur_pos,
                     window=None, scale=None) -> torch.Tensor:
    """A short query span (one decode token or a chunked-prefill bite)
    against a KV cache, possibly a ring.

    q: (B, Lq, H, D); k_cache, v_cache: (B, S, KH, D); entry_pos: (S,)
    or (B, S) absolute position of each entry (-1 = empty); cur_pos:
    each query's position, scalar, (B,) first-query positions or (B, Lq).
    Causality and the window come from the entry tags alone."""
    b, lq, h, d = q.shape
    kh = k_cache.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if entry_pos.ndim == 1:
        entry_pos = entry_pos[None]
    qpos = torch.as_tensor(cur_pos, device=q.device)
    if qpos.ndim == 0:
        qpos = qpos[None, None]
    elif qpos.ndim == 1:
        qpos = qpos[:, None] + torch.arange(lq, device=q.device)
    qpos = qpos.expand(b, lq)
    qf = q.reshape(b, lq, kh, h // kh, d)
    sc = _scores(qf, k_cache) * scale
    e = entry_pos[:, None, :]
    valid = (e >= 0) & (e <= qpos[:, :, None])
    if window is not None:
        valid = valid & (e > qpos[:, :, None] - window)
    sc = torch.where(valid[:, :, None, None, :], sc, NEG_INF)
    out = torch.einsum("bqgrk,bkgd->bqgrd", torch.softmax(sc, dim=-1),
                       v_cache.float())
    return out.reshape(b, lq, h, d).to(q.dtype)


def binary_flash_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, delta, alpha: float,
                           causal: bool = True, window=None, q_offset=0,
                           kv_valid_len=None, scale=None,
                           binarize_scores: bool = True,
                           q_chunk: int = 1024,
                           kv_chunk: int = 2048) -> torch.Tensor:
    """Chunked binary attention (no softmax, one pass): scores ``Q K^T *
    scale`` in fp32, thresholded as ``fma32(scores, scale, -delta) >= 0``
    (the FMA jitted XLA contracts ``scores * scale - delta`` into; its
    gradient is the surrogate's), or kept analog with
    ``binarize_scores=False``; masked entries are 0; the context is
    summed over kv chunks in fp32. Shapes as :func:`flash_attention`."""
    from repro_torch.core.spiking import spike   # lazy: core imports nn
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qp, kp, vp, qc, kc = _chunks(q, k, v, q_chunk, kv_chunk)
    dev = q.device
    kvl = None if kv_valid_len is None else torch.as_tensor(kv_valid_len,
                                                            device=dev)
    base = torch.as_tensor(q_offset, device=dev)
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev)
    outs = []
    for qi in range(qp.shape[1]):
        q_blk = qp[:, qi]
        qpos = base + qi * qc + torch.arange(qc, device=dev)
        acc = torch.zeros(q_blk.shape, dtype=torch.float32, device=dev)
        for ki in range(kp.shape[1]):
            kpos = ki * kc + torch.arange(kc, device=dev)
            s = _scores(q_blk, kp[:, ki])
            a = spike(fma32(s, scale, -delta), alpha) if binarize_scores \
                else s * scale
            mask = _chunk_mask(qpos, kpos, lk, causal, window, kvl)
            a = torch.where(mask[:, :, None, None, :], a, 0.0)
            acc = acc + _context(a, vp[:, ki])
        outs.append(acc.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(b, -1, h, d)[:, :lq]


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each ``positions.shape + (head_dim // 2,)`` fp32: the
    angles ``pos * theta^(-i / half)`` in fp32 as the reference forms
    them, their cos and sin in float64 rounded once."""
    half = head_dim // 2
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32),
                      -torch.arange(half, dtype=torch.float32) / half)
    ang = positions.float()[..., None] * freqs.to(positions.device)
    ang = ang.double()
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope_rotate(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> torch.Tensor:
    """The rotation on fp32 halves, with the reference's contraction:
    ``[fma(x1, cos, -(x2 sin)), fma(x2, cos, x1 sin)]``."""
    half = y.shape[-1] // 2
    x1, x2 = y[..., :half].float(), y[..., half:].float()
    return torch.cat([fma32(x1, cos, -(x2 * sin)),
                      fma32(x2, cos, x1 * sin)], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Apply RoPE. x: (B, L, H, D); positions: (B, L) or (L,)."""
    positions = torch.as_tensor(positions, device=x.device)
    if positions.ndim == 1:
        positions = positions[None]
    cos, sin = rope_table(positions, x.shape[-1], theta)
    return rope_rotate(x, cos[:, :, None, :], sin[:, :, None, :]
                       ).to(x.dtype)


def batchnorm_init(d: int, dtype=torch.bfloat16):
    return {"scale": torch.ones((d,), dtype=dtype),
            "bias": torch.zeros((d,), dtype=dtype)}


def batchnorm_state_init(d: int):
    return {"mean": torch.zeros((d,), dtype=torch.float32),
            "var": torch.ones((d,), dtype=torch.float32)}


def batchnorm(p, state, x: torch.Tensor, *, train: bool = False,
              momentum: float = 0.9, eps: float = 1e-5):
    """BN over all leading axes; returns (y, new_state).

    Train mode normalises with the batch mean and population variance
    (``unbiased=False``, as ``jnp.var``) and differentiates through them;
    the running stats become ``momentum * old + (1 - momentum) * batch``,
    contracted as XLA contracts it (``fma32(momentum, old, (1 - momentum)
    * batch)``), and carry no gradient (JAX returns them as aux)."""
    x32 = x.float()
    if train:
        axes = tuple(range(x.ndim - 1))
        mu = x32.mean(dim=axes)
        var = x32.var(dim=axes, unbiased=False)
        with torch.no_grad():
            new_state = {k: fma32(state[k], momentum, (1 - momentum) * v)
                         for k, v in (("mean", mu), ("var", var))}
    else:
        mu, var = state["mean"], state["var"]
        new_state = state
    y = bn_affine(x32, mu, torch.rsqrt(var + eps), p["scale"].float(),
                  p["bias"].float())
    return y.to(x.dtype), new_state


def conv2d_init(gen, c_in: int, c_out: int, ksize: int = 3,
                dtype=torch.bfloat16):
    std = 1.0 / math.sqrt(c_in * ksize * ksize)
    return {"w": normal(gen, (ksize, ksize, c_in, c_out), std, dtype)}


def conv2d(p, x: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 conv in fp32. x: (B, H, W, C) NHWC; w: HWIO."""
    w = p["w"].float().permute(3, 2, 0, 1)              # OIHW
    kh, kw = w.shape[2:]
    pad = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)
    xc = F.pad(x.float().permute(0, 3, 1, 2), pad)
    # the reference convolves in full fp32; cuDNN would default to TF32.
    # The scope turns TF32 off for this call only and passes the other
    # cuDNN settings through as the caller left them.
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(xc, w)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 VALID max pool on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1)


def causal_depthwise_conv1d(x: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """x: (B, L, C); w: (K, C) depthwise causal conv (mamba's front
    conv): fp32 taps summed in order, cast back to x's dtype."""
    k = w.shape[0]
    xpad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xpad[:, i:i + x.shape[1]].float() * w[i].float()
    return out.to(x.dtype)


def sinusoid_positions(length: int, d: int, *, device=None) -> torch.Tensor:
    """(length, d) fp32 [sin | cos] table: the angles ``pos / 10000^(2i /
    d)`` in fp32 as the reference forms them, their sin and cos in
    float64 rounded once (XLA's fp32 power differs from torch's by an
    ulp on some exponents, which moves an angle by up to two ulps)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = (pos / torch.pow(torch.tensor(10000.0, device=device),
                           2 * dim / d)).double()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()
