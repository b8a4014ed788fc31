"""The port's fused LIF kernel entry (``kernels/lif``, ``ops.lif``)
against the JAX package's Pallas ``lif_forward`` (interpret mode, as the
JAX tests run it).

* ``lif_forward_plain`` (what the wrapper runs on CPU tensors) equals the
  Pallas kernel bitwise: fp32 and bf16 currents, hard and soft reset,
  decay 0.5 and 2/3;
* the membrane update's rounding is pinned on constructed inputs where a
  fused multiply-add and two roundings of ``decay * u + i`` disagree
  about a spike: the interpret-mode kernel contracts (XLA's FMA), and so
  does the port;
* ``ops.lif`` on a (T, B, L, D) input equals JAX's; in fp32 with decay
  0.5 it equals ``lif_scan``'s spikes, in bf16 it does not everywhere
  (the kernel's membrane is fp32, ``lif_scan``'s the activation dtype);
  it takes an M that the JAX kernel's block assertion refuses;
* the launcher rejects operands the kernel does not take.

Spikes are exact, so every comparison is bitwise. The CUDA kernel is held
against the plain version on the card by ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import lif as JL  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro_torch.core.spiking import SpikingConfig, lif_scan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import lif as TL  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402

from test_torch_spike_kernels import DTYPES, _both  # noqa: E402

DECAYS = [0.5, 2.0 / 3.0]


def _currents(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.3, 0.8, shape)).astype(np.float32)


def _as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _fma(decay, u, x):
    """fp32 ``decay * u + x`` rounded once (the contracted update)."""
    return (np.float64(np.float32(decay)) * u.astype(np.float64)
            + x.astype(np.float64)).astype(np.float32)


def _two(decay, u, x):
    """fp32 ``decay * u + x`` with the product rounded apart."""
    return (np.float32(decay) * u + x).astype(np.float32)


def _lif_np(x, decay, v_th=1.0, soft=False, update=_fma):
    """LIF over the leading axis with an fp32 membrane and the given
    rounding of the update."""
    th = np.float32(v_th)
    u = np.zeros(x.shape[1:], np.float32)
    out = []
    for xt in x.astype(np.float32):
        u = update(decay, u, xt)
        s = (u >= th).astype(np.float32)
        u = (u - s * th) if soft else u * (np.float32(1) - s)
        out.append(s)
    return np.stack(out)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lif_plain_bitwise_against_pallas_kernel(dtype, soft, decay):
    x = _currents(int(decay * 10) + soft, (4, 48, 40))
    jx, tx = _both(x, dtype)
    want = _as_np(JL.lif_forward(jx, decay=decay, v_th=1.0, soft_reset=soft))
    got = TL.lif_forward(tx, decay=decay, v_th=1.0, soft_reset=soft)
    assert got.dtype == DTYPES[dtype][1] and got.shape == x.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert 0 < want.mean() < 1


def _ties(dtype, decay, n=6):
    """(i0, i1, v_th) with i0 < v_th, where the contracted update
    ``fma(decay, i0, i1)`` reaches v_th and the separately rounded one
    does not, or the reverse: the spike at step 1 tells the roundings
    apart. Values exact in ``dtype``."""
    rng = np.random.default_rng(11)
    i0 = np.asarray(jnp.asarray(rng.uniform(0.05, 0.9, 20000), DTYPES[dtype][0]
                                ).astype(jnp.float32))
    i1 = np.asarray(jnp.asarray(rng.uniform(0.05, 1.0, 20000), DTYPES[dtype][0]
                                ).astype(jnp.float32))
    fma, two = _fma(decay, i0, i1), _two(decay, i0, i1)
    th = np.maximum(fma, two)
    ok = np.nonzero((fma != two) & (i0 < th))[0][:n]
    assert len(ok) == n
    return [(i0[j], i1[j], th[j]) for j in ok]


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lif_update_rounds_as_the_contracted_fma(dtype, soft):
    """On each constructed tie the Pallas kernel's spike at step 1 is the
    FMA's, not the two roundings'; the port's equals the kernel's at
    every step (the third step's current continues from the reset)."""
    decay = 2.0 / 3.0
    for i0, i1, th in _ties(dtype, decay):
        x = np.empty((3, 2, 8), np.float32)
        x[0], x[1], x[2] = i0, i1, 0.5
        jx, tx = _both(x, dtype)
        want = _as_np(JL.lif_forward(jx, decay=decay, v_th=float(th),
                                     soft_reset=soft))
        got = TL.lif_forward(tx, decay=decay, v_th=float(th),
                             soft_reset=soft)
        np.testing.assert_array_equal(got.float().numpy(), want)
        np.testing.assert_array_equal(
            want, _lif_np(x, decay, float(th), soft, update=_fma))
        assert (_lif_np(x, decay, float(th), soft, update=_two)[1]
                != want[1]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_lif_matches_jax(dtype):
    """(T, B, L, D) currents: the middle dims fold into M on both sides."""
    x = _currents(3, (4, 2, 8, 24))
    jx, tx = _both(x, dtype)
    for soft in (False, True):
        want = _as_np(JO.lif(jx, decay=0.5, v_th=1.0, soft_reset=soft))
        got = TO.lif(tx, decay=0.5, v_th=1.0, soft_reset=soft)
        assert got.shape == x.shape and got.dtype == DTYPES[dtype][1]
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("soft", [False, True])
def test_ops_lif_fp32_equals_lif_scan(soft):
    """decay 0.5 (the models' tau of 2): ``decay * u`` is exact, so the
    fp32 kernel and ``lif_scan`` agree bitwise."""
    x = torch.from_numpy(_currents(4, (4, 3, 16, 32)))
    cfg = SpikingConfig(time_steps=4, tau=2.0, soft_reset=soft)
    got = TO.lif(x, decay=cfg.decay, v_th=cfg.v_threshold, soft_reset=soft)
    assert torch.equal(got, lif_scan(x, cfg)[0])


def test_bf16_kernel_keeps_an_fp32_membrane_unlike_lif_scan():
    """bf16 currents: the kernel's fp32 membrane and ``lif_scan``'s bf16
    one fire differently on a few entries; the port's kernel entry equals
    JAX's everywhere."""
    x = _currents(5, (4, 512, 256))
    jx, tx = _both(x, "bfloat16")
    want = _as_np(JO.lif(jx, decay=0.5))
    got = TO.lif(tx, decay=0.5)
    np.testing.assert_array_equal(got.float().numpy(), want)
    scan = lif_scan(tx, SpikingConfig(time_steps=4, tau=2.0))[0]
    differ = float((scan != got).float().mean())
    assert 0 < differ < 0.01, differ


def test_ops_lif_takes_any_m_where_jax_asserts():
    """M = 300 is not a multiple of the JAX kernel's 256-row block, which
    it asserts; the port's entry takes it and equals the numpy loop."""
    x = _currents(6, (4, 300, 20))
    with pytest.raises(AssertionError):
        JO.lif(jnp.asarray(x), decay=2.0 / 3.0)
    got = TO.lif(torch.from_numpy(x), decay=2.0 / 3.0)
    np.testing.assert_array_equal(got.numpy(), _lif_np(x, 2.0 / 3.0))


@pytest.mark.parametrize("case", ["dtype", "rank", "contiguous", "device"])
def test_lif_launcher_rejects_operands_before_launching(case):
    """Each bad operand raises ValueError before any build or launch, and
    the wrapper never finishes a non-CPU tensor on the CPU."""
    x = torch.zeros((4, 6, 8))
    bad = {"dtype": (x.half(), "float32 or bfloat16"),
           "rank": (x[0], r"\(T, M, D\)"),
           "contiguous": (x.transpose(1, 2), "contiguous")}
    if case == "device":
        with pytest.raises(ValueError, match="CPU or CUDA"):
            TL.lif_forward(x.to("meta"), decay=0.5)
    else:
        a, msg = bad[case]
        with pytest.raises(ValueError, match=msg):
            TL.lif_forward_cuda(a, decay=0.5)
        if case != "contiguous":
            with pytest.raises(ValueError, match=msg):
                TL.lif_forward(a, decay=0.5)
    assert "lif" in _build.SOURCES
    assert TL.LAUNCHES["lif_forward"] == 0
