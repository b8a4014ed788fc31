"""The binary engine's attention past 2048 keys, and the popcount counts
at shapes whose count stream is not a multiple of 16 bytes, against the
JAX package.

* ``ops.binary_attention`` on CPU tensors (the plain route of
  ``spike_attention``, or of ``popcount_scores`` with
  ``use_popcount=True``) at L = 2100, one key past a 2048-key chunk of
  the CUDA kernel plus a partial word, causal or not, against the jitted
  JAX ``binary_attention`` in its MXU mode (the interpret-mode Pallas
  ``spike_attention``): binarized scores bitwise, analog ones within
  ``L * hd * scale * 2^-23`` (two orders of one fp32 sum of at most L
  scores of at most ``hd * scale``; at hd 16 the sums are exact, so
  this holds them to 0 in practice);
* ``popcount_scores_plain`` bitwise against the interpret-mode Pallas
  ``popcount_scores`` at Lq x Lk of 5 x 7 and 50 x 70 (a count stream no
  multiple of 4, where the kernel's groups of 4 counts wrap rows and
  heads) and 196 x 196 (8-512's), at 1 to 4 words a row.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` at the same kinds of shape.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bitpack as JB  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import popcount_attention as JPA  # noqa: E402
from repro_torch.core import bitpack as TB  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import popcount_attention as TPA  # noqa: E402

# BH, L, head dim: L past the CUDA kernel's 2048-key chunk, and no
# multiple of its 64-query block or of a 32-key word
LONG = (2, 2100, 16)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _spikes(rng, shape, density):
    return (rng.random(shape) < density).astype(np.float32)


def _long_operands(seed):
    rng = np.random.default_rng(seed)
    return [_spikes(rng, LONG, p) for p in (0.4, 0.4, 0.5)]


@pytest.mark.parametrize("mode", ["mxu", "popcount"])
@pytest.mark.parametrize("binarize", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_long_binary_attention_against_jitted_jax_mxu_mode(causal, binarize,
                                                          mode):
    bh, l, d = LONG
    dtypes = ["float32", "bfloat16"] if binarize else ["float32"]
    q, k, v = _long_operands(30 + 2 * causal + binarize)
    scale = 1.0 / math.sqrt(d)
    kw = dict(scale=scale, delta=0.9, causal=causal,
              binarize_scores=binarize)
    for dtype in dtypes:
        jd, td = DTYPES[dtype]
        want = np.asarray(jax.jit(lambda a, b, c: JO.binary_attention(
            a, b, c, use_popcount=False, **kw))(
                *(jnp.asarray(x, jd) for x in (q, k, v))), np.float32)
        got = TO.binary_attention(*(torch.from_numpy(x).to(td)
                                    for x in (q, k, v)),
                                  use_popcount=mode == "popcount", **kw)
        assert got.dtype == td and got.shape == LONG
        assert want.std() > 0
        if binarize:
            np.testing.assert_array_equal(got.float().numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=l * d * scale * 2.0 ** -23)
        if causal:
            # the last query reads keys past 2048; the first reads one key
            np.testing.assert_array_equal(got[:, 0].float().numpy(),
                                          want[:, 0])


@pytest.mark.parametrize("words", [1, 2, 3, 4])
@pytest.mark.parametrize("lq, lk", [(5, 7), (50, 70), (196, 196)])
def test_popcount_scores_plain_bitwise_at_wrapping_shapes(lq, lk, words):
    rng = np.random.default_rng(10 * lq + words)
    bh, d = 3, 32 * words - 5          # a zero-padded last word
    q, k = _spikes(rng, (bh, lq, d), 0.3), _spikes(rng, (bh, lk, d), 0.3)
    q[0, 0] = 1.0
    k[-1, -1] = 1.0
    jq, jk = JB.pack_bits(jnp.asarray(q)), JB.pack_bits(jnp.asarray(k))
    tq, tk = TB.pack_bits(torch.from_numpy(q)), TB.pack_bits(
        torch.from_numpy(k))
    assert tq.shape == (bh, lq, words)
    want = np.asarray(JPA.popcount_scores(jq, jk))
    got = TPA.popcount_scores(tq, tk)
    assert got.dtype == torch.int32 and got.shape == (bh, lq, lk)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.einsum("bqd,bkd->bqk", q, k))
    assert want[0, 0].max() > 0
