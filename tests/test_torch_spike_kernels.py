"""The port's sparse-engine and binary-engine kernels against the JAX
package's Pallas kernels (interpret mode, as the JAX tests run them).

* ``spike_matmul_plain`` (what the wrapper runs on CPU tensors) equals
  JAX ``spike_matmul`` bitwise on dyadic weights — fp32 and bf16, shapes
  that do not divide the blocks, dark tiles, spikes or integer counts on
  the left, with and without bias, the fp32 accumulator rounded once to
  the operands' dtype; ``block_occupancy`` equals JAX's;
* ``spike_attention_plain`` equals JAX ``spike_attention`` bitwise on
  spikes — causal or not, L not a multiple of the block, fp32 and bf16,
  thresholds above and below zero — and on the tie points where jitted
  XLA's contracted ``scores * scale - delta`` and a separately rounded
  product disagree; analog scores agree within a stated tolerance;
* the wrappers check their operands and never fall back off the CPU.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import spike_attention as JA  # noqa: E402
from repro.kernels import spike_matmul as JM  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import spike_attention as TA  # noqa: E402
from repro_torch.kernels import spike_matmul as TM  # noqa: E402

from _torch_helpers import dyadic  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, dtype):
    """numpy array -> (jax array, torch CPU tensor) of one dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)
                                                ).to(td)


def _spikes(rng, shape, density=0.3):
    return (rng.random(shape) < density).astype(np.float32)


# --- spike_matmul ----------------------------------------------------------

MATMUL_CASES = [
    # (M, K, N, dark row / column ranges): ragged in every dim
    (37, 45, 19, slice(0, 16), slice(0, 16)),
    (64, 96, 48, slice(32, 64), slice(64, 96)),
    (130, 70, 33, slice(100, 130), slice(0, 0)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("case", range(len(MATMUL_CASES)))
def test_spike_matmul_plain_bitwise_against_jax_kernel(dtype, bias, case):
    m, k, n, dark_r, dark_c = MATMUL_CASES[case]
    rng = np.random.default_rng(case)
    s = _spikes(rng, (m, k))
    s[dark_r, :16] = 0.0                # whole dark tiles at block 16
    s[:, dark_c] = 0.0
    w = dyadic(rng, (k, n))
    b = dyadic(rng, (n,)) if bias else None
    js, ts = _both(s, dtype)
    jw, tw = _both(w, dtype)
    jb, tb = (None, None) if b is None else _both(b, dtype)
    # the fp32 accumulator rounded once to the operands' dtype (the JAX
    # kernel's default out_dtype)
    want = np.asarray(JM.spike_matmul(js, jw, bias=jb, block_m=16,
                                      block_n=16, block_k=16
                                      ).astype(jnp.float32))
    got = TM.spike_matmul(ts, tw, tb)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        TM.spike_matmul_plain(ts, tw, tb).float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spike_matmul_counts_operand_bitwise(dtype):
    """Binary-attention counts (integers up to L = 64) on the left, as
    the wo projection sees them."""
    rng = np.random.default_rng(7)
    s = rng.integers(0, 65, (48, 40)).astype(np.float32)
    s[:16] = 0.0
    w = dyadic(rng, (40, 24))
    js, ts = _both(s, dtype)
    jw, tw = _both(w, dtype)
    want = np.asarray(JM.spike_matmul(js, jw, block_m=16, block_n=16,
                                      block_k=16).astype(jnp.float32))
    np.testing.assert_array_equal(TM.spike_matmul(ts, tw).float().numpy(),
                                  want)


def test_block_occupancy_matches_jax():
    rng = np.random.default_rng(3)
    s = _spikes(rng, (64, 96), density=0.02)
    s[:, :32] = 0.0
    for bm, bk in ((16, 16), (32, 32), (64, 32)):
        want = np.asarray(JM.block_occupancy(jnp.asarray(s), bm, bk))
        got = TM.block_occupancy(torch.from_numpy(s), bm, bk)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < want.size


# --- spike_attention -------------------------------------------------------

ATTN_CASES = [
    # (BH, L, d, causal, delta, block)
    (3, 16, 32, False, 0.3, 8),
    (3, 13, 32, True, 0.3, 8),      # L not a multiple of the block
    (2, 13, 16, False, -0.1, 8),    # delta <= 0: dark keys pass too
    (2, 20, 32, True, 0.9, 16),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_spike_attention_plain_bitwise_against_jax_kernel(dtype, case):
    bh, l, d, causal, delta, blk = ATTN_CASES[case]
    rng = np.random.default_rng(10 + case)
    q, k, v = (_spikes(rng, (bh, l, d), density=p) for p in (0.4, 0.4, 0.5))
    k[0, :4] = 0.0                       # a dark key block
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    scale = 1.0 / math.sqrt(d)
    want = np.asarray(JA.spike_attention(jq, jk, jv, scale=scale,
                                         delta=delta, causal=causal,
                                         block_q=blk, block_k=blk
                                         ).astype(jnp.float32))
    got = TA.spike_attention(tq, tk, tv, scale=scale, delta=delta,
                             causal=causal)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert want.std() > 0


def test_spike_attention_threshold_ties_follow_the_contracted_fma():
    """Where ``count * scale`` rounds up onto delta, a separately rounded
    product passes the threshold and the fused multiply-add does not. The
    Pallas kernel contracts (interpret mode runs jitted, so eager calls
    do too); the jnp oracle rounds apart when eager and contracts under
    jit. The port follows the kernel and the jitted train step."""
    d = 32
    scale = 1.0 / math.sqrt(d)
    s32 = np.float32(scale)
    ties = [c for c in range(1, d + 1)
            if np.float32(c) * s32 > np.float64(c) * np.float64(s32)]
    assert ties
    l = 4
    for c in ties[:4]:
        delta = float(np.float32(c) * s32)
        q = np.zeros((1, l, d), np.float32)
        k = np.zeros_like(q)
        v = np.ones_like(q)
        q[0, :, :c] = 1.0
        k[0, 0, :c] = 1.0                # key 0 overlaps every query by c
        want = np.asarray(jax.jit(lambda a, b, e: JA.spike_attention(
            a, b, e, scale=scale, delta=delta))(q, k, v))
        got = TA.spike_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 scale=scale, delta=delta)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == 0).all(), c      # the tie does not pass
        eager = JA.spike_attention(q, k, v, scale=scale, delta=delta)
        np.testing.assert_array_equal(np.asarray(eager), want)
        oracle = lambda a, b, e: JO._jnp_folded(a, b, e, jnp.float32(delta),
                                                4.0, scale, False, True)
        assert (np.asarray(oracle(q, k, v))[0, :, 0] == 1).all()
        assert (np.asarray(jax.jit(oracle)(q, k, v)) == 0).all()


def test_spike_attention_analog_scores_within_tolerance():
    """binarize_scores=False: the context sums up to L analog scores
    count * scale in fp32 in another order than XLA's, so entries agree to
    L * max|score| * 2^-23 (about 1e-5 here), not bitwise."""
    rng = np.random.default_rng(5)
    bh, l, d = 2, 13, 16
    q, k, v = (_spikes(rng, (bh, l, d), density=0.5) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    for causal in (False, True):
        want = np.asarray(JA.spike_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
            delta=0.0, causal=causal, binarize_scores=False, block_q=8,
            block_k=8))
        got = TA.spike_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 scale=scale, delta=0.0, causal=causal,
                                 binarize_scores=False).numpy()
        tol = l * d * scale * 2.0 ** -23
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        assert np.abs(want).max() > 1.0


# --- wrappers --------------------------------------------------------------


def test_wrappers_check_operands_and_devices():
    s = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="spike_matmul takes"):
        TM.spike_matmul(s, torch.zeros((7, 3)))
    with pytest.raises(ValueError, match="bias"):
        TM.spike_matmul(s, torch.zeros((8, 3)), torch.zeros(4))
    q = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="spike_attention takes"):
        TA.spike_attention(q, q[:, :3], q, scale=1.0, delta=0.0)
    # neither wrapper finishes a non-CPU tensor on the CPU
    meta = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        TM.spike_matmul(meta, torch.zeros((8, 3), device="meta"))
    qm = torch.zeros((2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        TA.spike_attention(qm, qm, qm, scale=1.0, delta=0.0)
    # the CUDA launchers refuse what the kernels do not take, before any
    # build or launch
    with pytest.raises(ValueError, match="one dtype"):
        TM.spike_matmul_cuda(s.half(), torch.zeros((8, 3)).half())
    with pytest.raises(ValueError, match="contiguous"):
        TM.spike_matmul_cuda(torch.zeros((8, 4)).t(), torch.zeros((8, 3)))
    # spike_attention's kernel takes any head dim (160 here): what it
    # refuses is operands it cannot read as one dtype's dense rows
    wide = torch.zeros((1, 8, 160))
    with pytest.raises(ValueError, match="one dtype"):
        TA.spike_attention_cuda(wide, wide.bfloat16(), wide, scale=1.0,
                                delta=0.0)
    with pytest.raises(ValueError, match="contiguous"):
        TA.spike_attention_cuda(wide, wide.transpose(1, 2).contiguous()
                                .transpose(1, 2), wide, scale=1.0, delta=0.0)
    assert {"spike_matmul", "spike_attention"} <= set(_build.SOURCES)
    assert TM.LAUNCHES["spike_matmul"] == 0
    assert TA.LAUNCHES["spike_attention"] == 0
