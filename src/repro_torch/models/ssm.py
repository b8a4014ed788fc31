"""Mamba-style selective SSM layer (hymba's parallel mamba heads).

Mirrors ``repro.models.ssm``: the Mamba-1 selective scan with
input-dependent (dt, B, C) and a diagonal A, a causal depthwise conv in
front and a gated output; the state is (B, d_inner, d_state) fp32.

* dt is JAX's ``jax.nn.softplus``, ``logaddexp(x, 0)``, written out as
  ``max(x, 0) + log1p(exp(-|x|))``: ``F.softplus`` returns ``x`` itself
  above its threshold of 20, which differs in the last bits.
* The recurrence is a loop over the tokens, as JAX's ``lax.scan``. The
  decay ``exp(dt A)`` and the input ``dt B x`` of every token are formed
  before it (the same elementwise products, so the same values), and
  each token's output ``h C`` is read from the stacked states after it:
  two launches a token.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from . import nn
from .transformer import dtype_of


def d_inner_of(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def dt_rank_of(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def ssm_init(gen: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    s = cfg.ssm
    d = cfg.d_model
    di = d_inner_of(cfg)
    dr = dt_rank_of(cfg)
    a_init = torch.arange(1, s.d_state + 1, dtype=torch.float32).repeat(di,
                                                                        1)
    return {
        "in_proj": nn.linear_init(gen, d, 2 * di, dtype=dt),
        "conv_w": nn.normal(gen, (s.d_conv, di), 1.0 / math.sqrt(s.d_conv),
                            dt),
        "conv_b": torch.zeros((di,), dtype=dt),
        "x_proj": nn.linear_init(gen, di, dr + 2 * s.d_state, dtype=dt),
        "dt_proj": nn.linear_init(gen, dr, di, bias=True, dtype=dt),
        "A_log": torch.log(a_init),
        "D": torch.ones((di,), dtype=torch.float32),
        "out_proj": nn.linear_init(gen, di, d, dtype=dt),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_params(p, x_c: torch.Tensor, cfg: ModelConfig):
    """x_c: (B, S, di) post-conv -> (dt (B, S, di), Bm (B, S, N), Cm (B, S,
    N)), fp32."""
    s = cfg.ssm
    dr = dt_rank_of(cfg)
    dbc = nn.linear(p["x_proj"], x_c)
    dt_r, bm, cm = torch.split(dbc, [dr, s.d_state, s.d_state], dim=-1)
    dt = softplus(nn.linear(p["dt_proj"], dt_r).float())
    return dt, bm.float(), cm.float()


def ssm_forward(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None):
    """Full-sequence selective scan. x: (B, S, D); ``state`` (B, di, N)
    and ``conv_state`` (B, K-1, di) continue an earlier call (None: zero
    state, zero-padded conv). Returns (y (B, S, D), the final ssm state,
    the final conv state)."""
    s = cfg.ssm
    b, slen, _ = x.shape
    di = d_inner_of(cfg)
    x_in, z = nn.linear(p["in_proj"], x).chunk(2, dim=-1)
    if conv_state is not None:
        x_pad = torch.cat([conv_state, x_in], dim=1)
    else:
        x_pad = F.pad(x_in, (0, 0, s.d_conv - 1, 0))
    # causal depthwise conv over the padded buffer
    out = torch.zeros((b, slen, di), dtype=torch.float32, device=x.device)
    for i in range(s.d_conv):
        out = out + x_pad[:, i:i + slen].float() * p["conv_w"][i].float()
    x_c = F.silu(out + p["conv_b"].float()).to(x.dtype)

    dt, bm, cm = _ssm_params(p, x_c, cfg)
    a = -torch.exp(p["A_log"])                                   # (di, N)
    xf = x_c.float()
    da = torch.exp(dt[..., None] * a)                            # (B,S,di,N)
    dbx = dt[..., None] * bm[:, :, None, :] * xf[..., None]
    h = torch.zeros((b, di, s.d_state), dtype=torch.float32,
                    device=x.device) if state is None else state
    hs = []
    for t in range(slen):
        h = da[:, t] * h + dbx[:, t]
        hs.append(h)
    ys = torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1), cm)
    y = ys + xf * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    new_conv = x_pad[:, -(s.d_conv - 1):] if s.d_conv > 1 else \
        x_pad[:, :0]
    return nn.linear(p["out_proj"], y), h, new_conv


def ssm_decode(p, x: torch.Tensor, cfg: ModelConfig, state, conv_state):
    """One-token decode. x: (B, 1, D); state (B, di, N); conv (B, K-1,
    di)."""
    return ssm_forward(p, x, cfg, state=state, conv_state=conv_state)


def zero_states(cfg: ModelConfig, n_layers: int, b: int,
                dev: torch.device):
    s = cfg.ssm
    di = d_inner_of(cfg)
    return {
        "ssm": torch.zeros((n_layers, b, di, s.d_state),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros((n_layers, b, s.d_conv - 1, di),
                            dtype=dtype_of(cfg), device=dev),
    }
