"""The port's substrate against the JAX package, bitwise.

Each function of ``repro_torch`` gets the same numpy inputs as its
counterpart in ``repro`` and must return the same bits as the *jitted*
JAX function (compiled XLA contracts mul+add into FMAs, so the eager
JAX result is not the contract). BN variances are drawn where XLA's
rsqrt and ``torch.rsqrt`` agree; the one-ulp gap between them is pinned
separately.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import spiking as jsp  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro_torch.core import spiking as tsp  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402

from _torch_helpers import (  # noqa: E402
    EPS, agreeing_variances, dyadic, jit_rsqrt)


@pytest.mark.parametrize("soft_reset", [False, True])
def test_lif_scan_bitwise(soft_reset):
    rng = np.random.default_rng(0)
    cur = rng.normal(0.6, 0.8, (6, 3, 5, 17)).astype(np.float32)
    cfg_j = jsp.SpikingConfig(time_steps=6, soft_reset=soft_reset)
    cfg_t = tsp.SpikingConfig(time_steps=6, soft_reset=soft_reset)
    sj, uj = jax.jit(lambda c: jsp.lif_scan(c, cfg_j))(cur)
    st, ut = tsp.lif_scan(torch.from_numpy(cur), cfg_t)
    assert np.asarray(sj).sum() > 0
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(uj), ut.numpy())


def test_batchnorm_eval_bitwise():
    rng = np.random.default_rng(1)
    d = 48
    x = rng.normal(0, 2, (7, 5, d)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.3, d).astype(np.float32),
         "bias": rng.normal(0, 0.3, d).astype(np.float32)}
    st = {"mean": rng.normal(0, 0.5, d).astype(np.float32),
          "var": agreeing_variances(rng, d)}
    yj, _ = jax.jit(lambda p, s, x: jnn.batchnorm(p, s, x, train=False))(
        p, st, x)
    tt = {k: torch.from_numpy(v) for k, v in st.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    yt, _ = tnn.batchnorm(tp, tt, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


def test_rsqrt_gap_is_small_and_real_at_var_one():
    """The reason the bitwise tests filter variances: XLA's rsqrt and
    torch's differ on about a third of inputs, by one ulp and on a few in
    a thousand by two, including var = 1, which every freshly
    initialised BN state holds."""
    rng = np.random.default_rng(2)
    var = np.concatenate([[1.0], rng.uniform(0.01, 100.0, 4095)]
                         ).astype(np.float32)
    rj = np.asarray(jit_rsqrt(var)).view(np.int32)
    rt = torch.rsqrt(torch.from_numpy(var) + EPS).numpy().view(np.int32)
    gap = np.abs(rj.astype(np.int64) - rt)
    assert gap.max() <= 2
    assert 0.2 < (gap > 0).mean() < 0.5
    assert gap[0] == 1


@pytest.mark.parametrize("shape,cout", [((2, 8, 8, 3), 5),
                                        ((3, 7, 5, 4), 6)])
def test_conv2d_same_nhwc_bitwise(shape, cout):
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 256, shape) / 256.0).astype(np.float32)
    w = dyadic(rng, (3, 3, shape[-1], cout))
    yj = jax.jit(lambda w, x: jnn.conv2d({"w": w}, x))(w, x)
    yt = tnn.conv2d({"w": torch.from_numpy(w)}, torch.from_numpy(x))
    assert yt.shape == tuple(yj.shape)
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 7, 9, 2)])
def test_maxpool2_bitwise(shape):
    rng = np.random.default_rng(4)
    x = rng.normal(size=shape).astype(np.float32)
    yj = jax.jit(jnn.maxpool2)(x)
    yt = tnn.maxpool2(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())


def test_fma32_matches_xla_contracted_multiply_add():
    rng = np.random.default_rng(5)
    a, b, c = (rng.normal(0, 3, 1 << 16).astype(np.float32)
               for _ in range(3))
    yj = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    yt = tnn.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    np.testing.assert_array_equal(yj, yt)
    # a separately rounded multiply and add is not what XLA computes
    assert (yj != (torch.from_numpy(a) * torch.from_numpy(b)
                   + torch.from_numpy(c)).numpy()).any()
