"""Shared inputs for the tests that hold ``repro_torch`` against ``repro``.

Inputs are made with numpy from a seed and handed to both packages.
Values sit on a dyadic grid so every fp32 contraction is an exact sum,
and BN variances are drawn where XLA's rsqrt and ``torch.rsqrt`` agree,
so the two packages can be compared bit for bit.
"""
import jax
import numpy as np
import torch

EPS = 1e-5
jit_rsqrt = jax.jit(lambda v: jax.lax.rsqrt(v + EPS))


def agreeing_variances(rng, n, low=0.25, high=4.0):
    """BN running variances on which jitted ``jax.lax.rsqrt(var + eps)``
    and ``torch.rsqrt(var + eps)`` agree bitwise (the rest resampled)."""
    var = rng.uniform(low, high, n).astype(np.float32)
    for _ in range(100):
        bad = (np.asarray(jit_rsqrt(var))
               != torch.rsqrt(torch.from_numpy(var) + EPS).numpy())
        if not bad.any():
            return var
        var[bad] = rng.uniform(low, high, int(bad.sum())).astype(np.float32)
    raise AssertionError("could not draw agreeing variances")


def dyadic(rng, shape, bits=8):
    """Values k * 2^-bits with |k| < 2^bits: fp32 sums of their products
    with {0,1} spikes or k/256 images are exact in any order."""
    return (rng.integers(-(1 << bits), 1 << bits, shape)
            * 2.0 ** -bits).astype(np.float32)


def bn_rows(rng, n):
    """(4, n) eval BN rows [mean, var, scale, bias]."""
    return np.stack([dyadic(rng, n) * 0.5, agreeing_variances(rng, n),
                     1.0 + dyadic(rng, n) * 0.5, dyadic(rng, n) * 0.5])


def lif_np(x, decay=0.5, v_th=1.0):
    """Hard-reset LIF over the leading axis (exact on dyadic currents)."""
    u = np.zeros_like(x[0])
    out = []
    for xt in x:
        u = decay * u + xt
        s = (u - v_th >= 0).astype(x.dtype)
        u = u * (1.0 - s)
        out.append(s)
    return np.stack(out)


def layer_ops(seed, t, b, l, d, heads, hd, ff, *, scales=False):
    """Raw fused-layer operands (the layout ``engine.layer_step`` builds)
    as numpy arrays: dyadic currents with a dark (t=0, b=0) slab and an
    all-zero row, their LIF spikes, dyadic weights, d_ff zero-padded to a
    multiple of ``heads`` with identity BN rows."""
    rng = np.random.default_rng(seed)
    q_dim = heads * hd
    x = (rng.integers(-64, 224, (t, b, l, d)) / 128.0).astype(np.float32)
    x[:, :, min(2, l - 1)] = 0.0
    x[0, 0] = 0.0
    s = lif_np(x)
    w3 = dyadic(rng, (3, d, q_dim))
    wo = dyadic(rng, (q_dim, d)) * 0.25
    w1 = dyadic(rng, (d, ff))
    w2 = dyadic(rng, (ff, d)) * 0.25
    auxp = np.stack([bn_rows(rng, q_dim) for _ in range(3)])
    auxo, aux1, aux2 = bn_rows(rng, d), bn_rows(rng, ff), bn_rows(rng, d)
    sc = None
    if scales:
        sc = [1.0 + dyadic(rng, n, bits=4) * 0.5
              for n in ((3, q_dim), (d,), (ff,), (d,))]
    pad = (-ff) % heads
    if pad:
        w1 = np.pad(w1, ((0, 0), (0, pad)))
        w2 = np.pad(w2, ((0, pad), (0, 0)))
        ident = np.tile(np.array([0.0, 1.0, 1.0, 0.0], np.float32)[:, None],
                        (1, pad))
        aux1 = np.concatenate([aux1, ident], axis=1)
        if sc is not None:
            sc[2] = np.pad(sc[2], (0, pad), constant_values=1.0)
    scales_out = None if sc is None else tuple(sc)
    return (x, s, w3, wo, w1, w2, scales_out, auxp, auxo, aux1, aux2,
            np.float32(0.3))


def to_torch(args):
    """Numpy operands (nested in tuples) -> CPU tensors."""
    if args is None:
        return None
    if isinstance(args, tuple):
        return tuple(to_torch(a) for a in args)
    return torch.from_numpy(np.array(args))
