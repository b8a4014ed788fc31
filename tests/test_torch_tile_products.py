"""What the tile products' CUDA skeleton must follow, on the CPU.

``csrc/spike_matmul.cu`` runs the sparse engine's tile products, #2
``spike_matmul`` and #3 ``quant_spike_matmul``, on the tensor cores,
which sum in an order of their own. The card holds each kernel against
its plain version (``chip_smoke.check_matmul`` and ``hold_quant``); this
file pins what the plain version of #2 computes against the JAX
package's interpret-mode Pallas ``spike_matmul``, on the operands the
redesign is checked on:

* analog contexts (non-integer and negative values with -0.0, the wo
  product of an analog-score layer) on dyadic weights, fp32 and bf16,
  with and without bias: bitwise, since the least set bits of the
  operands prove every partial sum exact (asserted) in any order;
* the same on random-normal weights: within ``2 (K - 1) 2^-24 sum_k
  |s_k w_kn|`` (two fp32 orders of a K-term sum) plus, in bf16, one bf16
  ulp of the output — the bound the card's check applies;
* binary-attention counts up to 196 (Spikingformer-8-512's wo, L = 196)
  in bf16, where every count is an exact bf16 value: bitwise;
* the analog mode (``analog=True``), which sums in ascending k, one
  rounded product and one rounded sum a term: bitwise against that order
  restated in numpy, and against the Pallas kernel as above;

and that ``_build.library_path`` names a new library when a header in
``csrc/`` changes (the sources include ``int8_lanes.cuh``), so a stale
build is never loaded.
"""
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import spike_matmul as JM  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import spike_matmul as TM  # noqa: E402

from _torch_helpers import dyadic  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (M, K, N): ragged against the blocks, and one that is not
SHAPES = [(40, 72, 24), (64, 96, 48)]
BLOCK = 16


def _both(a, dtype):
    """numpy array -> (jax array, torch CPU tensor) of one dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)
                                                ).to(td)


def _analog(rng, shape):
    """An analog context: ragged rows of multiples of 1/16 in (-4, 4),
    -0.0 at every dark entry of the second half of the rows and in the
    first 4 columns, the first 8 rows dark."""
    live = rng.random(shape) < rng.random((shape[0], 1)) * 0.6
    v = rng.integers(-63, 64, shape) / 16.0
    s = np.where(live, v, 0.0).astype(np.float32)
    half = shape[0] // 2
    s[half:] = np.where(live[half:], s[half:], np.float32(-0.0))
    s[:, :4] = np.float32(-0.0)
    s[:8] = 0.0
    return s


def _least_bit(a):
    """The exponent of the least set bit among a's non-zero values."""
    nz = a[a != 0].astype(np.float64)
    m, e = np.frexp(nz)
    mi = (np.abs(m) * 2.0 ** 24).astype(np.int64)
    return int((e - 24 + np.log2(mi & -mi)).min())


def _jax(s, w, b, dtype):
    js, _ = _both(s, dtype)
    jw, _ = _both(w, dtype)
    jb = None if b is None else _both(b, dtype)[0]
    return np.asarray(JM.spike_matmul(js, jw, bias=jb, block_m=BLOCK,
                                      block_n=BLOCK, block_k=BLOCK
                                      ).astype(jnp.float32))


def _torch(s, w, b, dtype):
    _, ts = _both(s, dtype)
    _, tw = _both(w, dtype)
    tb = None if b is None else _both(b, dtype)[1]
    got = TM.spike_matmul_plain(ts, tw, tb)
    assert got.dtype == DTYPES[dtype][1]
    return got.float().numpy(), ts.double().numpy(), tw.double().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_analog_context_on_dyadic_weights_bitwise(dtype, bias, shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k)
    s = _analog(rng, (m, k))
    w = dyadic(rng, (k, n))
    b = dyadic(rng, (n,)) if bias else None
    got, s64, w64 = _torch(s, w, b, dtype)
    # every term ctx * w is a multiple of 2^(e_s + e_w); the partial sums
    # are exact in fp32 in any order while they stay below 2^(24 + e_s + e_w)
    room = 2.0 ** (24 + _least_bit(s64) + _least_bit(w64))
    assert float((np.abs(s64) @ np.abs(w64)).max()) < room
    assert np.signbit(s).any() and (s != np.round(s)).any()
    np.testing.assert_array_equal(got, _jax(s, w, b, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_analog_context_on_normal_weights_within_bound(dtype, shape):
    m, k, n = shape
    rng = np.random.default_rng(3 * m + k)
    s = _analog(rng, (m, k))
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    got, s64, w64 = _torch(s, w, None, dtype)
    want = _jax(s, w, None, dtype).astype(np.float64)
    tol = 2 * (k - 1) * 2.0 ** -24 * (np.abs(s64) @ np.abs(w64))
    if dtype == "bfloat16":
        tol = tol + 2.0 ** -7 * np.abs(want)
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_analog_mode_sums_in_ascending_k(dtype, shape):
    """The analog mode (``analog=True``, the wo product on the analog
    context of a ``binarize_scores=False`` layer): every output an fp32
    chain over ascending k, one rounded product and one rounded sum a
    term, the bias after the last, rounded once to the dtype, which is
    the order the CUDA kernel's analog mode takes. Bitwise against that
    order restated in numpy, through the wrapper too; against the
    interpret-mode Pallas kernel bitwise on dyadic weights with a bias
    (the sums are exact) and, without one, within the two-order bound on
    random-normal weights."""
    m, k, n = shape
    rng = np.random.default_rng(5 * m + k)
    s = _analog(rng, (m, k))
    cases = (((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
              None, False),
             (dyadic(rng, (k, n)), dyadic(rng, (n,)), True))
    for w, b, exact in cases:
        _, ts = _both(s, dtype)
        _, tw = _both(w, dtype)
        tb = None if b is None else _both(b, dtype)[1]
        got = TM.spike_matmul_plain(ts, tw, tb, analog=True)
        assert got.dtype == DTYPES[dtype][1]
        assert torch.equal(got, TM.spike_matmul(ts, tw, tb, analog=True))
        s32, w32 = ts.float().numpy(), tw.float().numpy()
        acc = np.zeros((m, n), np.float32)
        for kk in range(k):
            acc = acc + s32[:, kk:kk + 1] * w32[kk]
        if tb is not None:
            acc = acc + tb.float().numpy()
        assert torch.equal(got, torch.from_numpy(acc).to(got.dtype))
        want = _jax(s, w, b, dtype).astype(np.float64)
        if exact:
            np.testing.assert_array_equal(got.float().numpy(), want)
            continue
        tol = 2 * (k - 1) * 2.0 ** -24 * (np.abs(s32.astype(np.float64))
                                          @ np.abs(w32.astype(np.float64)))
        if dtype == "bfloat16":
            tol = tol + 2.0 ** -7 * np.abs(want)
        assert (np.abs(got.float().numpy() - want) <= tol).all()


@pytest.mark.parametrize("bias", [False, True])
def test_counts_up_to_196_in_bf16_bitwise(bias):
    """Spikingformer-8-512's wo on its binary-attention counts (L = 196):
    every count is an exact bf16 value, so the products on dyadic weights
    are exact."""
    rng = np.random.default_rng(196)
    s = rng.integers(0, 197, (48, 64)).astype(np.float32)
    s[rng.random((48, 64)) < 0.5] = 0.0
    s[:16] = 0.0
    assert s.max() == 196
    w = dyadic(rng, (64, 40))
    b = dyadic(rng, (40,)) if bias else None
    got, _, _ = _torch(s, w, b, "bfloat16")
    np.testing.assert_array_equal(got, _jax(s, w, b, "bfloat16"))


@pytest.mark.parametrize("name", _build.SOURCES)
def test_library_path_follows_the_headers(name, tmp_path, monkeypatch):
    """A changed, added or removed header in csrc/ names a new library for
    every source; a change to another source does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["int8_lanes.cuh"]
    seen = {_build.library_path(name)}
    headers[0].write_text(headers[0].read_text() + "// edited\n")
    seen.add(_build.library_path(name))
    (csrc / "extra.cuh").write_text("#pragma once\n")
    seen.add(_build.library_path(name))
    (csrc / "extra.cuh").unlink()
    assert _build.library_path(name) in seen
    assert len(seen) == 3
    other = next(o for o in _build.SOURCES if o != name)
    before = _build.library_path(name)
    (csrc / f"{other}.cu").write_text((csrc / f"{other}.cu").read_text()
                                      + "// edited\n")
    assert _build.library_path(name) == before
