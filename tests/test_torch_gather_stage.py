"""What the gather product's device staging must follow, on the CPU.

The CUDA path of ``repro_torch.kernels.spike_decode.gather_spike_matmul``
stages on the card (``gather_stage``): each row's occupancy and live
bits, and a stable counting sort by occupancy, held there bitwise to
``stage_rows``, the staging's plain version. This file pins what
``stage_rows`` and the plain product compute, against the JAX package:

* ``stage_rows`` on fp32 and bf16 values that hold -0.0, values in
  (0, 1), negatives and integer counts: its occupancies are JAX
  ``decode_indices``' (a value is live where it is not zero, so -0.0 is
  dark and 0.3 live), its order is JAX ``build_schedule``'s;
* the gather product's staging and the quantized product's differ: on
  values in (-1, 1) ``stage_rows`` of ``s`` counts entries that the
  int lanes (``quant_lanes``) drop, and the plain gather product sums
  them, so the two datapaths cannot share one live test;
* ``gather_spike_matmul_plain`` against the interpret-mode JAX
  ``gather_spike_matmul`` on analog non-integer and negative values with
  -0.0, an all-dark input, M not a multiple of ``block_m`` and K = 2048
  at a small M, with and without bias, fp32 and bf16: bitwise on dyadic
  values and weights; on random-normal ones (fp32) within
  ``test_torch_spike_decode``'s bound for two summation orders.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import spike_decode as JSD  # noqa: E402
from repro_torch.kernels import spike_decode as TSD  # noqa: E402
from repro_torch.kernels.spike_matmul import quant_lanes  # noqa: E402

from _torch_helpers import dyadic  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _analog(rng, m, k, density=0.3):
    """Dyadic analog values (multiples of 1/16 in (-2, 2), exact in bf16):
    non-integers, negatives, values in (0, 1), integer counts, -0.0
    entries and two dark rows."""
    s = rng.integers(-32, 33, (m, k)) * 2.0 ** -4
    s = np.where(rng.random((m, k)) < density, s, 0.0).astype(np.float32)
    s[:, :3] = -0.0
    s[1] = 0.0
    s[2] = -0.0
    s[3, 5:9] = [0.25, 0.5, 0.75, 1.0]
    s[4, 5:9] = [-0.25, -1.0, 3.0, 7.0]
    return s


def _normal(rng, m, k, density=0.3):
    s = rng.normal(0, 1, (m, k)).astype(np.float32)
    s = np.where(rng.random((m, k)) < density, s, 0.0).astype(np.float32)
    s[:, :3] = -0.0
    s[1] = 0.0
    return s


# (M, K, block_m): M a multiple of block_m and not
STAGE_SHAPES = [(64, 40, 16), (50, 70, 16), (37, 33, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", STAGE_SHAPES)
def test_stage_rows_is_jax_occupancy_and_order(dtype, shape):
    m, k, bm = shape
    rng = np.random.default_rng(m + k)
    s = _analog(rng, m, k)
    jd, td = DTYPES[dtype]
    order, sorted_occ = TSD.stage_rows(torch.from_numpy(s).to(td), bm)
    mp = -(-m // bm) * bm
    sp = np.zeros((mp, k), np.float32)
    sp[:m] = s
    _, jocc = JSD.decode_indices(jnp.asarray(sp, jd))
    jsched = JSD.build_schedule(jocc, bm, min(16, k), cap=k)
    assert order.dtype == torch.int64 and sorted_occ.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), np.asarray(jsched["order"]))
    np.testing.assert_array_equal(sorted_occ.numpy(),
                                  np.asarray(jocc)[np.asarray(jsched["order"])])
    # -0.0 is dark, every other non-zero value live
    np.testing.assert_array_equal(np.sort(np.asarray(jocc)[:m]),
                                  np.sort((s != 0).sum(1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_and_quant_stagings_differ_on_values_below_one(dtype):
    """A value in (-1, 1) is live for the gather product and dark on the
    quantized product's lane, so one row pass cannot stage both."""
    td = DTYPES[dtype][1]
    s = torch.zeros((16, 40))
    s[3, :6] = torch.tensor([0.25, -0.5, 0.75, -0.0, 2.0, -3.0])
    s[5, 10:20] = 0.5
    s = s.to(td)
    _, occ = TSD.stage_rows(s, 8)
    _, lane_occ = TSD.stage_rows(quant_lanes(s, counts=True), 8)
    assert occ.tolist() != lane_occ.tolist()
    assert sorted(occ.tolist())[-2:] == [5, 10]
    assert sorted(lane_occ.tolist())[-1] == 2
    w = torch.ones((40, 4), dtype=td)
    y = TSD.gather_spike_matmul_plain(s, w)
    assert y[5].tolist() == [5.0] * 4          # ten values of 0.5, summed
    assert y[3].tolist() == [-0.5] * 4         # 0.25 - 0.5 + 0.75 + 2 - 3


# (what, M, K, N, block_m, c_block)
GATHER_CASES = [
    ("analog", 64, 96, 24, 16, 32),
    ("all dark", 40, 64, 16, 16, 32),
    ("ragged M", 50, 70, 19, 16, 16),
    ("K=2048", 12, 2048, 8, 8, 512),
]


def _gather_operands(what, m, k, n, bias, weights, seed):
    rng = np.random.default_rng(seed)
    if weights == "dyadic":
        s = _analog(rng, m, k)
        w = dyadic(rng, (k, n))
    else:
        s = _normal(rng, m, k)
        w = rng.normal(0, 1, (k, n)).astype(np.float32)
    if what == "all dark":
        s = np.where(rng.random((m, k)) < 0.5, -0.0, 0.0).astype(np.float32)
    b = dyadic(rng, (n,)) if bias else None
    return s, w, b


def _jax_gather(s, w, b, jd, bm, cb):
    n = w.shape[1]
    return np.asarray(JSD.gather_spike_matmul(
        jnp.asarray(s, jd), jnp.asarray(w, jd),
        bias=None if b is None else jnp.asarray(b, jd), block_m=bm,
        block_n=n, c_block=cb).astype(jd).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("case", GATHER_CASES, ids=[c[0] for c in GATHER_CASES])
def test_gather_plain_bitwise_against_jax_kernel_on_analog_values(
        dtype, bias, case):
    what, m, k, n, bm, cb = case
    jd, td = DTYPES[dtype]
    s, w, b = _gather_operands(what, m, k, n, bias, "dyadic", m + k + n)
    want = _jax_gather(s, w, b, jd, bm, cb)
    got = TSD.gather_spike_matmul(
        torch.from_numpy(s).to(td), torch.from_numpy(w).to(td),
        None if b is None else torch.from_numpy(b).to(td), block_m=bm,
        c_block=cb)
    assert got.dtype == td and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if what == "all dark":
        assert np.array_equal(want, np.broadcast_to(
            np.zeros(n) if b is None else np.asarray(b, np.float32), want.shape))
    else:
        assert np.abs(want).max() > 0


@pytest.mark.parametrize("case", GATHER_CASES, ids=[c[0] for c in GATHER_CASES])
def test_gather_plain_random_normal_analog_within_bound(case):
    """Random-normal values and weights, fp32: the plain version sums each
    row's live products in ascending k, JAX's kernel in XLA's order inside
    each chunk; each differs from the exact sum by at most n * 2^-24 *
    sum |terms|, so the two by at most K * 2^-23 * sum |s * w|."""
    what, m, k, n, bm, cb = case
    s, w, _ = _gather_operands(what, m, k, n, False, "normal", m + k)
    want = _jax_gather(s, w, None, jnp.float32, bm, cb)
    got = TSD.gather_spike_matmul(torch.from_numpy(s), torch.from_numpy(w),
                                  block_m=bm, c_block=cb).numpy()
    bound = k * 2.0 ** -23 * (np.abs(s) @ np.abs(w))
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()
    if what != "all dark":
        assert np.abs(want).max() > 1.0
