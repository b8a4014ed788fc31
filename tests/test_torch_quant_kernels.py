"""The port's int8 sparse kernels against the JAX package's Pallas kernels
(interpret mode, as the JAX tests run them).

* ``quant_spike_matmul_plain`` (what the wrapper runs on CPU tensors)
  equals JAX ``quant_spike_matmul`` bitwise on random scales and biases:
  spikes, and integer counts up to 300 (past int8's 127), dark tiles,
  ragged M / K / N, with and without bias, fp32 out and rounded once to
  bf16 (JAX's output followed by the engine's cast); and equals the
  port's ``dense_quant_linear``. The epilogue is the jitted kernel's:
  ``acc * scale + b`` contracted into one fused multiply-add, which a
  separately rounded product and sum would miss;
* ``quant_gather_spike_matmul_plain`` equals JAX
  ``quant_gather_spike_matmul`` bitwise on the same cases plus empty
  rows and all-zero groups, and equals the tile version bitwise;
* ``spike_linear`` on a quantized dict with ``mode='sparse'``, both
  datapaths, spikes and counts: forward bitwise against JAX's
  ``spike_linear`` under the same engine, and the gradients of x, scale
  and bias against ``jax.grad`` through JAX's ``_quant_sparse_matmul``
  (bitwise on dyadic scales and cotangents, where every sum is exact);
* the wrappers check their operands and never fall back off the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import engine as JE  # noqa: E402
from repro.kernels import spike_decode as JD  # noqa: E402
from repro.kernels import spike_matmul as JM  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.kernels import spike_decode as TD  # noqa: E402
from repro_torch.kernels import spike_matmul as TM  # noqa: E402

from _torch_helpers import dyadic  # noqa: E402

# (M, K, N, counts, bias): ragged in every dim; K = 200 with counts > 127
CASES = [(37, 45, 19, False, False), (64, 96, 48, True, True),
         (130, 70, 33, False, True), (96, 200, 40, True, False)]
BLOCKS = dict(block_m=32, block_n=32)


def _operands(seed, m, k, n, counts, density=0.3):
    """Spikes (or counts up to 300) with a dark row block and a dark
    column block, int8 codes, random (not dyadic) scales and biases."""
    rng = np.random.default_rng(seed)
    s = (rng.random((m, k)) < density).astype(np.float32)
    if counts:
        s *= rng.integers(1, 301, (m, k))
    s[:16] = 0.0
    s[16:32, : k // 2] = 0.0
    qw = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    return s, qw, scale, bias


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a, copy=True)) for a in arrays)


@pytest.mark.parametrize("case", CASES)
def test_quant_spike_matmul_plain_matches_pallas(case):
    m, k, n, counts, with_bias = case
    s, qw, scale, bias = _operands(1, m, k, n, counts)
    b = bias if with_bias else None
    want = np.asarray(JM.quant_spike_matmul(
        jnp.asarray(s), jnp.asarray(qw), jnp.asarray(scale),
        bias=None if b is None else jnp.asarray(b), counts=counts,
        block_k=32, **BLOCKS))
    ts, tq, tsc, tb = _torch(s, qw, scale, bias)
    tb = tb if with_bias else None
    got = TM.quant_spike_matmul(ts, tq, tsc, tb, counts=counts)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got16 = TM.quant_spike_matmul(ts.bfloat16() if not counts else ts, tq,
                                  tsc, tb, counts=counts,
                                  out_dtype=torch.bfloat16)
    assert torch.equal(got16, torch.from_numpy(want.copy()).bfloat16())
    # the port's dense quantized reference rounds the same way (counts
    # up to 300 are exact in fp32)
    p = {"qw": tq, "scale": tsc, **({"b": tb} if with_bias else {})}
    np.testing.assert_array_equal(TE.dense_quant_linear(p, ts).numpy(), want)
    if with_bias:
        # a separately rounded product and sum is not what the kernel does
        sep = (TM.quant_spike_matmul(ts, tq, tsc, None, counts=counts)
               + tb).numpy()
        assert (sep != want).any()


@pytest.mark.parametrize("case", CASES)
def test_quant_gather_plain_matches_pallas(case):
    m, k, n, counts, with_bias = case
    s, qw, scale, bias = _operands(2, m, k, n, counts, density=0.1)
    rng = np.random.default_rng(3)
    s[:32] = 0.0                        # a whole dark group
    hi = min(40, m)                     # dense rows: a group of its own cap
    s[32:hi] = (rng.random((hi - 32, k)) < 0.9) * (1.0 + counts * 200)
    b = bias if with_bias else None
    want = np.asarray(JD.quant_gather_spike_matmul(
        jnp.asarray(s), jnp.asarray(qw), jnp.asarray(scale),
        bias=None if b is None else jnp.asarray(b), counts=counts,
        c_block=32, **BLOCKS))
    ts, tq, tsc, tb = _torch(s, qw, scale, bias)
    tb = tb if with_bias else None
    got = TD.quant_gather_spike_matmul(ts, tq, tsc, tb, counts=counts,
                                       block_m=32, c_block=32)
    np.testing.assert_array_equal(got.numpy(), want)
    tile = TM.quant_spike_matmul_plain(ts, tq, tsc, tb, counts=counts)
    assert torch.equal(got, tile)
    # the schedule has all-zero groups and groups of other capacities
    occ = (TD.pad_to_multiple(ts, 0, 32) != 0).sum(-1, dtype=torch.int32)
    caps = TD.build_schedule(occ, 32, 32, cap=k)["caps"]
    assert int(caps.min()) == 0 and len(set(caps.tolist())) > 1


def test_quant_int8_lanes_and_int4_codes():
    """Spikes ride int8 lanes, counts int32 lanes (a count of 200 on an
    int8 lane would wrap); int4 codes unpack to int8 before the kernel,
    so a packed int4 dict gives the dense reference's product."""
    s = torch.tensor([[200.0, 1.0]])
    assert TM.quant_lanes(s, True).dtype == torch.int32
    assert TM.quant_lanes(s[:, 1:], False).dtype == torch.int8
    qw = torch.tensor([[1, 2], [3, 4]], dtype=torch.int8)
    one = torch.ones(2)
    np.testing.assert_array_equal(
        TM.quant_spike_matmul(s, qw, one, counts=True).numpy(),
        [[203.0, 404.0]])
    from repro_torch.quant import quantize_weight
    gen = torch.Generator().manual_seed(0)
    q4 = quantize_weight(torch.randn((64, 24), generator=gen), "int4")
    assert q4["qw"].dtype == torch.uint8
    x = (torch.rand((40, 64), generator=gen) < 0.3).float()
    for path in ("tile", "decoded"):
        eng = TE.EngineConfig(mode="sparse", sparse=path, weights="int4")
        assert torch.equal(TE.spike_linear(q4, x, engine=eng),
                           TE.dense_quant_linear(q4, x))


def test_quant_wrappers_check_operands():
    s = torch.zeros((4, 8))
    qw = torch.zeros((8, 3), dtype=torch.int8)
    sc = torch.ones(3)
    for fn in (TM.quant_spike_matmul, TD.quant_gather_spike_matmul):
        with pytest.raises(ValueError, match="int8 weight codes"):
            fn(s, qw.to(torch.uint8), sc)
        with pytest.raises(ValueError, match="s \\(M, K\\)"):
            fn(s[:, :5], qw, sc)
        with pytest.raises(ValueError, match="scale has shape"):
            fn(s, qw, torch.ones(4))
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(s.to("meta"), qw, sc)


def test_quant_launchers_reject_output_dtype_before_launching():
    """The CUDA launchers write float32 or bfloat16 only, and raise before
    they build or launch anything (these operands lie on the CPU)."""
    s = torch.zeros((4, 8))
    qw = torch.zeros((8, 3), dtype=torch.int8)
    for fn in (TM.quant_spike_matmul_cuda, TD.quant_gather_spike_matmul_cuda):
        with pytest.raises(ValueError, match="writes float32 or bfloat16"):
            fn(s, qw, torch.ones(3), out_dtype=torch.float16)
    assert TM.LAUNCHES["quant_spike_matmul"] == 0
    assert TD.LAUNCHES["quant_gather_spike_matmul"] == 0


def _jax_engine(path):
    return JE.EngineConfig(mode="sparse", sparse=path, block_m=32,
                           block_n=32, block_k=32)


@pytest.mark.parametrize("path", ["tile", "decoded"])
@pytest.mark.parametrize("counts", [False, True])
def test_spike_linear_quantized_sparse_matches_jax(path, counts):
    """Forward bitwise; gradients of x, scale and bias bitwise against
    jax.grad on dyadic scales and cotangents (every product and sum of the
    backward is then exact), through a bias and without."""
    rng = np.random.default_rng(4)
    t, b, l, k, n = 2, 3, 16, 48, 40
    x = (rng.random((t, b, l, k)) < 0.3).astype(np.float32)
    if counts:
        x *= rng.integers(1, 5, x.shape)
    x[0, 0] = 0.0
    qw = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (2.0 ** -rng.integers(6, 9, n)).astype(np.float32)
    bias = dyadic(rng, n)
    g = dyadic(rng, (t, b, l, n), bits=2)
    jeng = _jax_engine(path)
    teng = TE.EngineConfig(mode="sparse", sparse=path, block_m=32,
                           block_k=32)
    for with_bias in (False, True):
        def jloss(xx, sc, bb):
            p = {"qw": jnp.asarray(qw), "scale": sc}
            if with_bias:
                p["b"] = bb
            y = JE.spike_linear(p, xx, engine=jeng, counts=counts)
            return (y * g).sum(), y

        (_, want), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        tx, tsc, tb = (torch.from_numpy(a.copy()).requires_grad_()
                       for a in (x, scale, bias))
        p = {"qw": torch.from_numpy(qw), "scale": tsc}
        if with_bias:
            p["b"] = tb
        got = TE.spike_linear(p, tx, engine=teng, counts=counts)
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        (got * torch.from_numpy(g)).sum().backward()
        np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrads[0]))
        np.testing.assert_array_equal(tsc.grad.numpy(), np.asarray(jgrads[1]))
        if with_bias:
            np.testing.assert_array_equal(tb.grad.numpy(),
                                          np.asarray(jgrads[2]))
        else:
            assert tb.grad is None


def test_spike_linear_quantized_bf16_rounds_once():
    """bf16 activations: the fp32 epilogue is rounded once to bf16 in the
    kernel's store (JAX's kernel output, then its cast), on random
    scales."""
    rng = np.random.default_rng(5)
    x = (rng.random((64, 48)) < 0.3).astype(np.float32)
    qw = rng.integers(-127, 128, (48, 24)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, 24).astype(np.float32)
    for path in ("tile", "decoded"):
        want = JE.spike_linear({"qw": jnp.asarray(qw),
                                "scale": jnp.asarray(scale)},
                               jnp.asarray(x, jnp.bfloat16),
                               engine=_jax_engine(path))
        got = TE.spike_linear(
            {"qw": torch.from_numpy(qw), "scale": torch.from_numpy(scale)},
            torch.from_numpy(x).bfloat16(),
            engine=TE.EngineConfig(mode="sparse", sparse=path, block_m=32,
                                   block_k=32))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
