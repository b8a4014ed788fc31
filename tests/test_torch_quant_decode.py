"""The redesigned quantized decoded product (``quant_gather_spike_matmul``)
on the CPU: the plain twins of its CUDA arithmetic, and its plain version
against the JAX package's Pallas kernel (interpret mode) on values the
earlier tests do not reach.

* the byte planes the kernel splits count lanes into (a signed top plane,
  unsigned lower ones, as few as the lanes' range allows) recombine by
  Horner's rule to the int32 sums exactly, edges of int32 included;
* the staging's lane cast (truncation toward zero) equals
  ``spike_matmul.quant_lanes`` on bf16 and fp32 values, non-integer and
  negative ones included;
* ``stage_rows`` (the staging's plain version) is the stable sort of the
  padded occupancies, equal to JAX ``build_schedule``'s order, over
  several of the staging's sort chunks;
* the kernel's integer product, restated in PyTorch (block unions of
  live lanes, 32-lane steps, byte planes), equals the int32 sums
  bitwise;
* ``quant_gather_spike_matmul_plain`` equals JAX
  ``quant_gather_spike_matmul`` bitwise on counts of 128-300 of either
  sign and above 65535, an analog non-integer context on count lanes,
  all-dark groups and an all-dark input, M not a multiple of ``block_m``
  and N not a multiple of 16, with and without bias, bf16 and fp32.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container has no hypothesis; use fixed-seed shim
    from _propcheck import given, settings, strategies as st

from repro.kernels import spike_decode as JD  # noqa: E402
from repro_torch.kernels import spike_decode as TD  # noqa: E402
from repro_torch.kernels import spike_matmul as TM  # noqa: E402

I32 = (-(1 << 31), (1 << 31) - 1)
EDGES = [I32[0], I32[1], 0, 1, -1, 127, 128, -128, -129, 255, 256, 32767,
         32768, -32768, -32769, (1 << 23) - 1, 1 << 23, -(1 << 23),
         -(1 << 23) - 1, 65535, 65536]


def _wrap(x):
    """int64 -> int32 modulo 2^32, as the kernels' int32 sums."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(*I32), min_size=1, max_size=24),
       st.integers(0, 2 ** 31 - 1))
def test_byte_planes_recombine_to_the_int32_sums(values, seed):
    v = torch.tensor(values + EDGES[seed % len(EDGES):][:3],
                     dtype=torch.int64)
    planes, unsigned = TD.lane_planes(v.min(), v.max())
    parts = TD.split_planes(v, planes, unsigned)
    assert len(parts) == planes
    for p, part in enumerate(parts):
        lo, hi = (0, 255) if p < planes - 1 or unsigned else (-128, 127)
        assert int(part.min()) >= lo and int(part.max()) <= hi
    assert torch.equal(TD.join_planes(parts), v.to(torch.int32))
    gen = torch.Generator().manual_seed(seed)
    codes = torch.randint(-127, 128, (v.numel(), 5), generator=gen)
    want = _wrap(v @ codes)
    got = TD.join_planes([part.long() @ codes for part in parts])
    assert torch.equal(got, want)


@pytest.mark.parametrize("lo, hi, want", [
    (0, 0, (1, True)), (0, 255, (1, True)), (-1, 127, (1, False)),
    (-128, 127, (1, False)), (0, 256, (2, False)), (-129, 0, (2, False)),
    (-32768, 32767, (2, False)), (0, 65535, (3, False)),
    (-(1 << 23), (1 << 23) - 1, (3, False)), (0, 1 << 23, (4, False)),
    (*I32, (4, False))])
def test_lane_planes_are_the_fewest_that_hold_the_range(lo, hi, want):
    assert TD.lane_planes(lo, hi) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts", [False, True])
def test_lane_cast_equals_quant_lanes(dtype, counts):
    rng = np.random.default_rng(1)
    top = 70000.0 if counts else 127.0
    vals = rng.uniform(-top, top, (40, 33)).astype(np.float32)
    vals[:, :8] = [0.0, 0.5, -0.5, 0.999, -0.999, 1.0, -1.0, 126.75]
    s = torch.from_numpy(vals).to(dtype)
    got = TD.lane_values(s, counts)
    want = TM.quant_lanes(s, counts)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _lanes(seed, m, k, counts, dark_rows=32):
    """Ragged fine-grained lanes: row densities from 0 to 0.6, the first
    rows dark, many rows of equal occupancy."""
    rng = np.random.default_rng(seed)
    live = rng.random((m, k)) < rng.random((m, 1)) * 0.6
    live[:dark_rows] = False
    vals = rng.integers(1, 301, (m, k)) if counts else np.ones((m, k))
    s = torch.from_numpy((live * vals).astype(np.float32))
    return TM.quant_lanes(s, counts)


@pytest.mark.parametrize("m, k, block_m", [(70, 40, 32), (2500, 24, 128),
                                           (300, 300, 128)])
def test_stage_rows_is_the_stable_sort_and_jax_order(m, k, block_m):
    lanes = _lanes(2, m, k, counts=True)
    order, sorted_occ = TD.stage_rows(lanes, block_m)
    occ = TD.pad_to_multiple((lanes != 0).sum(1, dtype=torch.int32), 0,
                             block_m)
    want_occ, want_order = torch.sort(occ, stable=True)
    assert torch.equal(order, want_order) and torch.equal(sorted_occ,
                                                          want_occ)
    sched = JD.build_schedule(jnp.asarray(occ.numpy()), block_m, 32, cap=k)
    np.testing.assert_array_equal(order.numpy(), np.asarray(sched["order"]))


def _union_lanes(lanes, order, rows=TD.QUANT_BLOCK_ROWS):
    """The lanes each block of the CUDA product decodes: for every
    ``rows`` consecutive rows of the staged ``order`` (padding rows dark),
    the union of their live lanes. Returns (blocks, K) bool."""
    m, k = lanes.shape
    live = torch.zeros((-(-order.numel() // rows) * rows, k),
                       dtype=torch.bool)
    real = order < m
    live[:order.numel()][real] = lanes[order[real]] != 0
    return live.reshape(-1, rows, k).any(dim=1)


def _union_product(lanes, qw, block_m=128):
    """The CUDA product's integer arithmetic: for each block of
    QUANT_BLOCK_ROWS sorted rows, its union of live lanes in ascending
    k, QUANT_KSTEP at a time, each step's lanes split into the byte
    planes the block's value range needs, each plane's product with the
    step's code rows joined by Horner's rule and added in int32. Returns
    the (M, N) int32 sums at the rows' own index."""
    m, k = lanes.shape
    order, _ = TD.stage_rows(lanes, min(block_m, m))
    x = lanes.to(torch.int32)
    acc = torch.zeros((m, qw.shape[1]), dtype=torch.int32)
    for b, union in enumerate(_union_lanes(lanes, order)):
        rows = order[b * TD.QUANT_BLOCK_ROWS:(b + 1) * TD.QUANT_BLOCK_ROWS]
        rows = rows[rows < m]
        if not union.any():
            continue
        xb = x[rows]
        planes, unsigned = TD.lane_planes(xb.min(), xb.max())
        ks = union.nonzero().flatten()
        total = acc[rows].long()
        for j in range(0, ks.numel(), TD.QUANT_KSTEP):
            step = ks[j:j + TD.QUANT_KSTEP]
            codes = qw[step].long()
            total += TD.join_planes([p.long() @ codes for p in TD.split_planes(
                xb[:, step], planes, unsigned)]).long()
        acc[rows] = total.to(torch.int32)
    return acc


@pytest.mark.parametrize("case", ["spikes", "counts", "negative", "2^23",
                                  "dark"])
def test_union_product_equals_the_int32_sums(case):
    m, k, n = 300, 100, 21
    lanes = _lanes(3, m, k, counts=case != "spikes").to(torch.int32)
    if case == "negative":
        lanes[::3] = -lanes[::3]
    elif case == "2^23":
        lanes[40::9, 7] = 1 << 23
        lanes[41::9, 8] = -(1 << 23) - 1
    elif case == "dark":
        lanes.zero_()
    if case == "spikes":
        lanes = lanes.to(torch.int8)
    qw = torch.from_numpy(np.random.default_rng(4).integers(
        -127, 128, (k, n)).astype(np.int8))
    want = _wrap(lanes.long() @ qw.long())
    assert torch.equal(_union_product(lanes, qw), want)
    order, _ = TD.stage_rows(lanes, 128)
    unions = _union_lanes(lanes, order)
    assert unions.shape == (-(-m // 128), k)
    for b, union in enumerate(unions):   # the OR of the block's live rows
        rows = order[128 * b:128 * (b + 1)]
        rows = rows[rows < m]
        assert torch.equal(union, (lanes[rows] != 0).any(dim=0))


# (what, M, K, N, counts, bias, dtype): M not a multiple of block_m = 32,
# N not a multiple of 16; the first 32 rows dark (a whole dark group)
PALLAS_CASES = [
    ("counts of 128-300, either sign", 70, 64, 19, True, True, "float32"),
    ("counts above 65535", 70, 48, 19, True, True, "bfloat16"),
    ("analog context", 70, 64, 19, True, False, "bfloat16"),
    ("all dark", 50, 40, 19, True, False, "float32"),
]


def _pallas_operands(what, m, k, n, counts):
    rng = np.random.default_rng(5)
    live = (rng.random((m, k)) < rng.random((m, 1)) * 0.6).astype(np.float32)
    live[:32] = 0.0
    if what == "counts of 128-300, either sign":
        s = live * rng.integers(128, 301, (m, k)) * rng.choice([-1, 1], (m, k))
    elif what == "counts above 65535":
        s = live * rng.integers(65536, 100001, (m, k))
    elif what == "analog context":
        s = live * rng.uniform(0.0, 300.0, (m, k))
    else:
        s = np.zeros((m, k))
    qw = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    return s.astype(np.float32), qw, scale, bias


@pytest.mark.parametrize("case", PALLAS_CASES,
                         ids=[f"{c[0]}-{c[6]}-{'bias' if c[5] else 'nobias'}"
                              for c in PALLAS_CASES])
def test_quant_gather_plain_matches_pallas_on_new_values(case):
    what, m, k, n, counts, with_bias, dtype = case
    s, qw, scale, bias = _pallas_operands(what, m, k, n, counts)
    ts = torch.from_numpy(s).to(getattr(torch, dtype))
    js = jnp.asarray(ts.float().numpy()).astype(getattr(jnp, dtype))
    b = bias if with_bias else None
    want = np.asarray(JD.quant_gather_spike_matmul(
        js, jnp.asarray(qw), jnp.asarray(scale),
        bias=None if b is None else jnp.asarray(b), counts=counts,
        block_m=32, block_n=32, c_block=32))
    tb = None if b is None else torch.from_numpy(b)
    kw = dict(counts=counts, block_m=32, c_block=32)
    got = TD.quant_gather_spike_matmul(ts, torch.from_numpy(qw),
                                       torch.from_numpy(scale), tb, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    got16 = TD.quant_gather_spike_matmul(ts, torch.from_numpy(qw),
                                         torch.from_numpy(scale), tb,
                                         out_dtype=torch.bfloat16, **kw)
    assert torch.equal(got16, torch.from_numpy(want).bfloat16())
    # the kernel's integer product and the tile version agree too
    lanes = TM.quant_lanes(ts, counts)
    acc = _union_product(lanes, torch.from_numpy(qw), 32)
    assert torch.equal(TM.quant_epilogue(acc, torch.from_numpy(scale), tb),
                       got)
    assert torch.equal(TM.quant_spike_matmul_plain(
        ts, torch.from_numpy(qw), torch.from_numpy(scale), tb,
        counts=counts), got)
