"""RWKV6 "Finch" (rwkv6-3b): attention-free, with data-dependent decay.

Mirrors ``repro.models.rwkv``: the data-dependent token shift (ddlerp:
low-rank adapters over the five mix targets r / k / v / w / g), the
per-channel decay ``w = exp(-exp(w0 + lora_w(x)))``, a per-head (n x n)
state with the bonus ``u``, the grouped head norm and the squared-ReLU
channel mix. Plain PyTorch, as JAX's is jnp: the binary engine does not
apply (there is no QK^T), and no kernel of the port runs.

* The WKV recurrence has JAX's two forms: :func:`_wkv_scan`, one token a
  step (decode, and a config with ``wkv_chunk`` 0), and
  :func:`_wkv_chunked`, a prompt in chunks of ``cfg.rwkv.wkv_chunk``
  tokens (inside a chunk the decays become cumulative log sums and the
  recurrence (C x C) products; the state is carried once a chunk). Both
  sum in fp32.
* :func:`_wkv_chunked` clamps the decays at 1e-38 before their log, as
  JAX's does. That constant is subnormal in fp32: XLA on the CPU flushes
  it to zero, so JAX's log gives -inf, and NaN follows, wherever a decay
  underflows (``w0 + lora`` above ~4.47); torch keeps the subnormal, its
  log is -87.5 and the port stays finite (ROADMAP queue 3).
* ``decode_step`` takes one token a row (or several, which continue the
  state as a prompt would); ``pos`` is not read, the state carries the
  position. The cache is updated in place and returned.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map
from . import nn
from .transformer import _layer as _layer_params
from .transformer import _stacked_layers, dtype_of

N_MIX = 5  # r, k, v, w, g
_WKV_CLIP = 35.0  # exp-argument clamp of the intra-chunk k rescale


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    r = cfg.rwkv
    d = cfg.d_model
    n = r.head_size
    std = 1.0 / math.sqrt(d)
    f32 = torch.float32
    tm = {
        "mu_x": torch.zeros((d,), dtype=dt),
        "mu": nn.normal(gen, (N_MIX, d), 0.02, dt),
        "A_mix": nn.normal(gen, (d, N_MIX * r.lora_mix), std, dt),
        "B_mix": nn.normal(gen, (N_MIX, r.lora_mix, d), 0.02, dt),
        "w0": nn.normal(gen, (d,), 0.5, f32) - 5.0,
        "A_w": nn.normal(gen, (d, r.lora_decay), std, dt),
        "B_w": nn.normal(gen, (r.lora_decay, d), 0.02, f32),
        "wr": nn.linear_init(gen, d, d, dtype=dt),
        "wk": nn.linear_init(gen, d, d, dtype=dt),
        "wv": nn.linear_init(gen, d, d, dtype=dt),
        "wg": nn.linear_init(gen, d, d, dtype=dt),
        "wo": nn.linear_init(gen, d, d,
                             std=std / math.sqrt(2 * cfg.num_layers),
                             dtype=dt),
        "u": nn.normal(gen, (d // n, n), 0.02, f32),
        "ln_x": nn.layernorm_init(d, dt),
    }
    cm = {
        "mu_k": torch.full((d,), 0.5, dtype=dt),
        "mu_r": torch.full((d,), 0.5, dtype=dt),
        "wk": nn.linear_init(gen, d, cfg.d_ff, dtype=dt),
        "wv": nn.linear_init(gen, cfg.d_ff, d, dtype=dt),
        "wr": nn.linear_init(gen, d, d, dtype=dt),
    }
    return {"ln1": nn.layernorm_init(d, dt), "tm": tm,
            "ln2": nn.layernorm_init(d, dt), "cm": cm}


def init(cfg: ModelConfig, seed: int = 0, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    """Params in the JAX layout (layer leaves stacked on a leading axis)
    from a ``torch.Generator`` on ``device`` (the GPU by default) seeded
    with ``seed`` (not JAX's numbers: tests convert JAX's params)."""
    dev = resolve_device(device)
    gen = nn.generator(dev).manual_seed(seed)
    dt = dtype_of(cfg)
    params = {
        "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "ln0": nn.layernorm_init(cfg.d_model, dt),
        "layers": _stacked_layers(gen, cfg, (cfg.num_layers,), dev,
                                  _layer_init),
        "final_norm": nn.layernorm_init(cfg.d_model, dt),
        "lm_head": nn.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                  dtype=dt),
    }
    return tree_map(lambda a: a.to(dev), params)


# ---------------------------------------------------------------------------
# time mix
# ---------------------------------------------------------------------------


def _ddlerp(tm, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Data-dependent token shift. x / x_prev: (B, S, D) -> (B, S, 5, D)."""
    xx = x_prev - x
    x_base = x + xx * tm["mu_x"].to(x.dtype)
    mix = torch.tanh(nn.linear({"w": tm["A_mix"]}, x_base))
    b, s, _ = mix.shape
    mix = mix.reshape(b, s, N_MIX, -1)
    lora = torch.einsum("bsfr,frd->bsfd", mix.float(), tm["B_mix"].float())
    mus = tm["mu"].float()[None, None]
    return x[:, :, None] + xx[:, :, None] * (mus + lora).to(x.dtype)


def _decay(tm, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1), fp32. xw: (B, S, D)."""
    lora = torch.tanh(nn.linear({"w": tm["A_w"]}, xw)).float()
    ww = tm["w0"] + lora @ tm["B_w"]
    return torch.exp(-torch.exp(ww))


def _wkv_scan(r, k, v, w, u, state):
    """Recurrent WKV. r / k / v / w: (B, S, H, n); state: (B, H, n, n).
    Returns (y (B, S, H, n), the final state), fp32."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,n,n)
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t],
                               state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state


def _wkv_chunked(r, k, v, w, u, state, chunk: int = 32):
    """Chunk-parallel WKV, the same function as :func:`_wkv_scan` (JAX's
    derivation, ``repro.models.rwkv._wkv_chunked``): with ``L_t`` the sum
    of ``log w`` inside a chunk up to t,

        y_t = (r_t e^{L_{t-1}}) S_0 + sum_{s<t} (r_t e^{L_{t-1}}) .
              (k_s e^{-L_s}) v_s + (r_t . (u k_t)) v_t
        S_next = e^{L_C} S_0 + sum_s (k_s e^{L_C - L_s})^T v_s

    Every exponent but ``-L_s`` is <= 0; ``-L_s`` is clamped at
    ``_WKV_CLIP``, which only decays below e^-35 inside one chunk reach.
    The sequence is padded to whole chunks with w = 1."""
    b, s_len, h, n = r.shape
    pad = (-s_len) % chunk
    if pad:
        widths = (0, 0, 0, 0, 0, pad)
        r, k, v = (F.pad(t, widths) for t in (r, k, v))
        w = F.pad(w, widths, value=1.0)
    nc = r.shape[1] // chunk
    shp = (b, nc, chunk, h, n)
    rc, kc, vc, wc = (t.float().reshape(shp) for t in (r, k, v, w))

    logw = torch.log(torch.clamp_min(wc, 1e-38))
    lcum = torch.cumsum(logw, dim=2)                   # L_t, <= 0
    lprev = lcum - logw                                # L_{t-1}
    a = rc * torch.exp(lprev)                          # (B,NC,C,H,n)
    bb = kc * torch.exp(torch.clamp_max(-lcum, _WKV_CLIP))
    scores = torch.einsum("bcthn,bcshn->bchts", a, bb)  # (B,NC,H,C,C)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    scores = torch.where(tri, scores, 0.0)
    diag = torch.einsum("bcthn,bcthn->bcht", rc, kc * u[None, None, None])
    eye = torch.eye(chunk, device=r.device)
    scores = scores + eye * diag[..., :, None]
    y_intra = torch.einsum("bchts,bcshn->bcthn", scores, vc)

    l_last = lcum[:, :, -1:]                           # (B,NC,1,H,n)
    kbar = kc * torch.exp(l_last - lcum)               # <= k, stable
    decay = torch.exp(l_last[:, :, 0])                 # (B,NC,H,n)
    y_state = []
    for c in range(nc):
        y_state.append(torch.einsum("bthn,bhnm->bthm", a[:, c], state))
        state = decay[:, c, :, :, None] * state + torch.einsum(
            "bthn,bthm->bhnm", kbar[:, c], vc[:, c])
    y = (y_intra + torch.stack(y_state, dim=1)).reshape(
        b, nc * chunk, h, n)[:, :s_len]
    return y, state


def _time_mix(tm, cfg: ModelConfig, x, x_prev, state):
    """x: (B, S, D); x_prev: (B, D) shift state; state: (B, H, n, n)."""
    b, s, d = x.shape
    n = cfg.rwkv.head_size
    h = d // n
    prev = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(tm, x, prev).unbind(2)
    r = nn.linear(tm["wr"], xr).reshape(b, s, h, n)
    k = nn.linear(tm["wk"], xk).reshape(b, s, h, n)
    v = nn.linear(tm["wv"], xv).reshape(b, s, h, n)
    g = F.silu(nn.linear(tm["wg"], xg))
    w = _decay(tm, xw).reshape(b, s, h, n)
    u = tm["u"].float()
    if cfg.rwkv.wkv_chunk and s > 1:
        y, state = _wkv_chunked(r, k, v, w, u, state,
                                chunk=cfg.rwkv.wkv_chunk)
    else:
        y, state = _wkv_scan(r, k, v, w, u, state)
    y = nn.groupnorm(tm["ln_x"], y.reshape(b, s, d).to(x.dtype), groups=h)
    return nn.linear(tm["wo"], y * g), x[:, -1], state


def _channel_mix(cm, x, x_prev):
    prev = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    xx = prev - x
    xk = x + xx * cm["mu_k"].to(x.dtype)
    xr = x + xx * cm["mu_r"].to(x.dtype)
    k = torch.relu(nn.linear(cm["wk"], xk)).square()
    kv = nn.linear(cm["wv"], k)
    gate = torch.sigmoid(nn.linear(cm["wr"], xr).float()).to(x.dtype)
    return gate * kv, x[:, -1]


def _layer(p, cfg: ModelConfig, x, st):
    """st: {'wkv': (B, H, n, n), 'tm_prev': (B, D), 'cm_prev': (B, D)};
    returns (x, the layer's new state)."""
    y, tm_prev, wkv = _time_mix(p["tm"], cfg, nn.layernorm(p["ln1"], x),
                                st["tm_prev"], st["wkv"])
    x = x + y
    y, cm_prev = _channel_mix(p["cm"], nn.layernorm(p["ln2"], x),
                              st["cm_prev"])
    return x + y, {"wkv": wkv, "tm_prev": tm_prev, "cm_prev": cm_prev}


def _zero_state(cfg: ModelConfig, n_layers: int, b: int,
                dev: torch.device):
    n = cfg.rwkv.head_size
    h = cfg.d_model // n
    dt = dtype_of(cfg)
    return {
        "wkv": torch.zeros((n_layers, b, h, n, n), dtype=torch.float32,
                           device=dev),
        "tm_prev": torch.zeros((n_layers, b, cfg.d_model), dtype=dt,
                               device=dev),
        "cm_prev": torch.zeros((n_layers, b, cfg.d_model), dtype=dt,
                               device=dev),
    }


def _head(params, x):
    x = nn.layernorm(params["final_norm"], x)
    return nn.linear(params["lm_head"], x).float()


def forward(params, cfg: ModelConfig, batch, *, train: bool = False,
            inputs_embeds: Optional[torch.Tensor] = None):
    """batch: {'tokens': (B, S)}; every layer starts from the zero state.
    Returns (logits (B, S, V) fp32, {})."""
    x = nn.embed(params["embed"], batch["tokens"]) if inputs_embeds is None \
        else inputs_embeds
    x = nn.layernorm(params["ln0"], x)
    st0 = {k: v[0] for k, v in _zero_state(cfg, 1, x.shape[0],
                                           x.device).items()}
    for i in range(cfg.num_layers):
        x, _ = _layer(_layer_params(params, i), cfg, x, st0)
    return _head(params, x), {}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, batch=None,
               params=None, chunk_headroom: int = 0, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """The zero state of every layer: {'wkv': (L, B, H, n, n) fp32,
    'tm_prev', 'cm_prev': (L, B, D)}; its size does not grow with
    ``max_len``."""
    return _zero_state(cfg, cfg.num_layers, batch_size,
                       resolve_device(device))


def decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                n_tok: Optional[torch.Tensor] = None):
    """O(1)-state decode: tokens (B, 1) continue every row's state.
    Returns (logits (B, 1, V) fp32, cache), the cache updated in place.
    JAX's takes no ``n_tok`` (no chunked bites, no per-slot state); nor
    does the port's."""
    if n_tok is not None:
        raise TypeError(f"{cfg.name}: rwkv decode carries one state a row, "
                        f"no n_tok")
    dev = params["embed"]["table"].device
    x = nn.embed(params["embed"], torch.as_tensor(tokens, device=dev))
    x = nn.layernorm(params["ln0"], x)
    for i in range(cfg.num_layers):
        x, new = _layer(_layer_params(params, i), cfg, x,
                        {k: v[i] for k, v in cache.items()})
        for key, value in new.items():
            cache[key][i].copy_(value)
    return _head(params, x), cache
