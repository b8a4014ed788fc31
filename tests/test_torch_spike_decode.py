"""The port's decoded sparse datapath (``repro_torch.kernels.spike_decode``,
the decoded variant of ``kernels.fused_layer``, ``sparse='auto'``)
against the JAX package.

* staging, element for element: ``pow2ceil``, ``decode_indices`` (also
  against ``core.sparsity``'s M-lane decoder), ``build_schedule`` (also
  against ``sim.balance_sim.bucket_schedule``), ``slab_decode`` and the
  path ``choose_sparse_path`` picks — coherent and ragged sparsity,
  all-zero rows, ragged M and K, ``cap < K`` and the cap guard;
* ``gather_spike_matmul_plain`` (what the wrapper runs on CPU tensors)
  against JAX ``gather_spike_matmul`` in interpret mode: bitwise on
  dyadic weights (fp32 and bf16, spikes and integer counts, with and
  without bias), within a stated bound on random-normal weights, and
  bitwise against the port's ``spike_matmul_plain`` on dyadic weights;
* the engine: ``resolve_sparse_path`` gives JAX's answer on the same
  concrete spikes and counts its 'auto' decisions; ``EngineConfig``
  validates ``block_k``; ``spike_linear`` takes the decoded kernel;
* the fused layer's decoded variant: the plain version against the
  jitted JAX ``reference_layer`` (bitwise, one and several L-blocks),
  its q/k/v counts against the closed form from JAX ``slab_decode``'s
  capacities, the other phases against the tile variant's counts.

The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py``.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import engine as JE  # noqa: E402
from repro.core import sparsity  # noqa: E402
from repro.core.spiking import SpikingConfig as JSpikingConfig  # noqa: E402
from repro.kernels import fused_layer as JFL  # noqa: E402
from repro.kernels import spike_decode as JSD  # noqa: E402
from repro.sim import balance_sim  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_layer as TFL  # noqa: E402
from repro_torch.kernels import spike_decode as TSD  # noqa: E402
from repro_torch.kernels import spike_matmul as TM  # noqa: E402

from _torch_helpers import dyadic, layer_ops, to_torch  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, dtype):
    """numpy array -> (jax array, torch CPU tensor) of one dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)
                                                ).to(td)


def _ragged(rng, m, k, lo=0.0, hi=0.6):
    """Per-row density uniform in [lo, hi]: ragged, fine-grained
    occupancy, with empty rows riding along."""
    dens = rng.uniform(lo, hi, (m, 1))
    return (rng.random((m, k)) < dens).astype(np.float32)


def _coherent(m, k):
    """Whole dark column tiles: the tile skip's regime."""
    s = np.zeros((m, k), np.float32)
    s[:, :32] = 1.0
    return s


# --- staging ----------------------------------------------------------------


def test_pow2ceil_matches_jax():
    x = np.concatenate([np.arange(-3, 4100), [2 ** 20 - 1, 2 ** 20,
                                              2 ** 20 + 1, 2 ** 30]]
                       ).astype(np.int32)
    want = np.asarray(JSD.pow2ceil(jnp.asarray(x)))
    got = TSD.pow2ceil(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


SPIKE_CASES = {
    "ragged": lambda rng: _ragged(rng, 37, 45),
    "coherent": lambda rng: _coherent(24, 96),
    "all_zero_rows": lambda rng: np.concatenate(
        [np.zeros((5, 33), np.float32), _ragged(rng, 11, 33)]),
    "counts": lambda rng: _ragged(rng, 20, 40) * rng.integers(
        1, 65, (20, 40)).astype(np.float32),
}


@pytest.mark.parametrize("case", list(SPIKE_CASES))
@pytest.mark.parametrize("cap", [None, "max"])
def test_decode_indices_matches_jax(case, cap):
    rng = np.random.default_rng(len(case))
    s = SPIKE_CASES[case](rng)
    cap = None if cap is None else int((s != 0).sum(1).max())
    jidx, jocc = JSD.decode_indices(jnp.asarray(s), cap=cap)
    tidx, tocc = TSD.decode_indices(torch.from_numpy(s), cap=cap)
    assert tidx.dtype == tocc.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))


def test_decode_cap_guard_raises_as_jax_does():
    s = np.ones((4, 16), np.float32)
    for mod, arr in ((JSD, jnp.asarray(s)), (TSD, torch.from_numpy(s))):
        with pytest.raises(ValueError, match="max row occupancy"):
            mod.decode_indices(arr, cap=8)
    idx, occ = TSD.decode_indices(torch.from_numpy(s), cap=16)
    np.testing.assert_array_equal(occ.numpy(), 16)


@pytest.mark.parametrize("m_lanes", [1, 3, 8])
def test_decode_indices_is_the_multilane_decoder(m_lanes):
    """Chunked by the lane count, the compacted stream is the M-lane
    carry-lookahead decoder's per-cycle lane sets."""
    rng = np.random.default_rng(m_lanes)
    bits = _ragged(rng, 12, 50, hi=0.8)
    bits[3] = 0.0
    idx, occ = TSD.decode_indices(torch.from_numpy(bits))
    for r in range(bits.shape[0]):
        cycles, _ = sparsity.multilane_decode_full(bits[r], m_lanes)
        n = int(occ[r])
        for c, cyc in enumerate(cycles):
            np.testing.assert_array_equal(
                idx[r, c * m_lanes: c * m_lanes + len(cyc)].numpy(), cyc)
        assert sum(len(c) for c in cycles) == n


@pytest.mark.parametrize("m,block_m,c_block,k", [
    (64, 16, 16, 40), (96, 32, 8, 100), (128, 8, 128, 300), (32, 32, 32, 7)])
def test_build_schedule_matches_jax_and_balance_sim(m, block_m, c_block, k):
    """Order (a stable sort: ties keep row order), caps, steps,
    executed/total and the MAC fraction; occupancies with many ties."""
    rng = np.random.default_rng(m + k)
    occ = rng.integers(0, min(k, 9) + 1, m).astype(np.int32)
    occ[:block_m] = 0                              # an all-zero group
    got = TSD.build_schedule(torch.from_numpy(occ), block_m, c_block, cap=k)
    want = JSD.build_schedule(jnp.asarray(occ), block_m, c_block, cap=k)
    for key in ("order", "caps", "steps"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert int(got["executed"]) == int(want["executed"])
    assert got["total"] == want["total"]
    assert got["padded_cap"] == want["padded_cap"]
    assert float(got["mac_fraction"]) == float(want["mac_fraction"])
    twin = balance_sim.bucket_schedule(occ, block_m, c_block, cap=k)
    np.testing.assert_array_equal(got["caps"].numpy(), twin["caps"])
    np.testing.assert_array_equal(got["steps"].numpy(), twin["steps"])
    assert (int(got["executed"]), got["total"]) == (twin["executed"],
                                                    twin["total"])


@pytest.mark.parametrize("case,shape,blocks,want_path", [
    ("coherent", (96, 160), (32, 32), "tile"),
    ("ragged", (96, 160), (32, 32), "decoded"),
    ("ragged", (50, 70), (16, 32), None),        # ragged M and K
    ("dense", (64, 64), (32, 32), "tile"),
])
def test_choose_sparse_path_matches_jax(case, shape, blocks, want_path):
    rng = np.random.default_rng(1)
    m, k = shape
    s = {"coherent": lambda: _coherent(m, k),
         "ragged": lambda: _ragged(rng, m, k, hi=0.2),
         "dense": lambda: np.ones((m, k), np.float32)}[case]()
    want = JSD.choose_sparse_path(jnp.asarray(s), *blocks)
    assert TSD.choose_sparse_path(torch.from_numpy(s), *blocks) == want
    if want_path is not None:
        assert want == want_path


@pytest.mark.parametrize("l_block,c_block,cap", [
    (8, 16, None), (16, 128, None), (5, 8, None), (8, 16, 24)])
def test_slab_decode_matches_jax(l_block, c_block, cap):
    """idx, vals, per-L-block caps and the clipped c_block; L not a
    multiple of l_block, K not a multiple of c_block, a dark slab."""
    rng = np.random.default_rng(l_block)
    s = _ragged(rng, 2 * 3 * 13, 40, hi=0.5).reshape(2, 3, 13, 40)
    s[0, 1] = 0.0
    if cap is not None:
        s = s * (np.arange(40) < cap)
    want = JSD.slab_decode(jnp.asarray(s), l_block=l_block,
                           c_block=c_block, cap=cap)
    got = TSD.slab_decode(torch.from_numpy(s), l_block=l_block,
                          c_block=c_block, cap=cap)
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] == want[3]


# --- gather_spike_matmul ----------------------------------------------------

GATHER_CASES = [
    # (M, K, N, block_m, c_block): ragged in every dim; several chunks
    (37, 45, 19, 16, 16),
    (64, 96, 48, 16, 32),
    (130, 70, 33, 32, 16),
]


def _gather_inputs(case, counts, bias, weights="dyadic"):
    m, k, n, _, _ = GATHER_CASES[case]
    rng = np.random.default_rng(20 + case)
    s = _ragged(rng, m, k)
    s[:16] = 0.0                                 # an all-zero group
    s[-1] = 1.0                                  # a dense row
    if counts:
        s = s * rng.integers(1, 65, (m, k)).astype(np.float32)
    w = dyadic(rng, (k, n)) if weights == "dyadic" else \
        rng.normal(0, 1, (k, n)).astype(np.float32)
    b = dyadic(rng, (n,)) if bias else None
    return s, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("case", range(len(GATHER_CASES)))
def test_gather_plain_bitwise_against_jax_kernel(dtype, counts, bias, case):
    s, w, b = _gather_inputs(case, counts, bias)
    _, _, _, bm, cb = GATHER_CASES[case]
    js, ts = _both(s, dtype)
    jw, tw = _both(w, dtype)
    jb, tb = (None, None) if b is None else _both(b, dtype)
    # the JAX kernel returns fp32; its engine casts to the activation dtype
    want = np.asarray(JSD.gather_spike_matmul(
        js, jw, bias=jb, block_m=bm, block_n=16, c_block=cb
    ).astype(DTYPES[dtype][0]).astype(jnp.float32))
    got = TSD.gather_spike_matmul(ts, tw, tb, block_m=bm, c_block=cb)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(GATHER_CASES)))
def test_gather_plain_bitwise_against_spike_matmul_plain(dtype, case):
    """Dyadic weights: every fp32 sum is exact, so the decoded order and
    the dense product agree to the bit."""
    s, w, b = _gather_inputs(case, counts=True, bias=True)
    _, _, _, bm, cb = GATHER_CASES[case]
    ts, tw, tb = (torch.from_numpy(a).to(DTYPES[dtype][1])
                  for a in (s, w, b))
    np.testing.assert_array_equal(
        TSD.gather_spike_matmul(ts, tw, tb, block_m=bm, c_block=cb
                                ).float().numpy(),
        TM.spike_matmul_plain(ts, tw, tb).float().numpy())


def test_gather_plain_random_normal_weights_within_bound():
    """Random-normal weights, fp32: the plain version sums each row's
    live products in ascending k, JAX's interpret-mode kernel in XLA's
    order inside each chunk. Each sum of n terms lies within n * 2^-24 *
    sum |terms| of the exact value, so the two differ by at most
    K * 2^-23 * sum |s * w| per entry."""
    for case in range(len(GATHER_CASES)):
        s, w, _ = _gather_inputs(case, counts=True, bias=False,
                                 weights="normal")
        _, k, _, bm, cb = GATHER_CASES[case]
        want = np.asarray(JSD.gather_spike_matmul(
            jnp.asarray(s), jnp.asarray(w), block_m=bm, block_n=16,
            c_block=cb))
        got = TSD.gather_spike_matmul(torch.from_numpy(s),
                                      torch.from_numpy(w), block_m=bm,
                                      c_block=cb).numpy()
        bound = k * 2.0 ** -23 * (np.abs(s) @ np.abs(w))
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()
        assert np.abs(want).max() > 1.0


def test_gather_wrapper_checks_operands_and_devices():
    s = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="gather_spike_matmul takes"):
        TSD.gather_spike_matmul(s, torch.zeros((7, 3)))
    with pytest.raises(ValueError, match="bias"):
        TSD.gather_spike_matmul(s, torch.zeros((8, 3)), torch.zeros(4))
    meta = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        TSD.gather_spike_matmul(meta, torch.zeros((8, 3), device="meta"))
    # the CUDA launcher refuses what the kernel does not take, before any
    # build or launch
    with pytest.raises(ValueError, match="one dtype"):
        TSD.gather_spike_matmul_cuda(s.half(), torch.zeros((8, 3)).half())
    with pytest.raises(ValueError, match="contiguous"):
        TSD.gather_spike_matmul_cuda(torch.zeros((8, 4)).t(),
                                     torch.zeros((8, 3)))
    assert "gather_spike_matmul" in _build.SOURCES
    before = TSD.LAUNCHES["gather_spike_matmul"]
    TSD.gather_spike_matmul(torch.ones((4, 8)), torch.ones((8, 3)))
    assert TSD.LAUNCHES["gather_spike_matmul"] == before == 0


# --- the engine ---------------------------------------------------------------


def test_resolve_sparse_path_matches_jax_and_counts_decisions():
    jauto = JE.EngineConfig(mode="sparse", sparse="auto", block_m=32,
                            block_n=32, block_k=32)
    tauto = TE.EngineConfig(mode="sparse", sparse="auto", block_m=32,
                            block_k=32)
    rng = np.random.default_rng(0)
    TE.reset_sparse_decisions()
    cases = [_coherent(96, 160), _ragged(rng, 96, 160, hi=0.2),
             _ragged(rng, 50, 70, hi=0.3)]
    seen = []
    for s in cases:
        want = JE.resolve_sparse_path(jauto, jnp.asarray(s))
        got = TE.resolve_sparse_path(tauto, torch.from_numpy(s))
        assert got == want
        seen.append(got)
        for path in ("tile", "decoded"):
            assert TE.resolve_sparse_path(tauto.replace(sparse=path),
                                          torch.from_numpy(s)) == path
            assert JE.resolve_sparse_path(jauto.replace(sparse=path),
                                          jnp.asarray(s)) == path
    assert seen[:2] == ["tile", "decoded"]
    assert TE.SPARSE_DECISIONS == {p: seen.count(p)
                                   for p in ("tile", "decoded")}
    # spikes of any rank are reshaped to (-1, K), as resolve_layer_plan
    # hands them to JAX
    s4 = cases[1].reshape(2, 3, 16, 160)
    assert TE.resolve_sparse_path(tauto, torch.from_numpy(s4)) == \
        JE.resolve_layer_plan(jauto, jnp.asarray(s4), 0).sparse
    assert TE.resolve_sparse_path(tauto, None) == "tile"
    assert TE.resolve_sparse_path(None, torch.from_numpy(s4)) == "tile"
    TE.reset_sparse_decisions()
    assert TE.SPARSE_DECISIONS == {"tile": 0, "decoded": 0}


def test_engine_config_validates_block_k():
    eng = TE.EngineConfig(block_k=64, sparse="decoded")
    assert (eng.block_m, eng.block_k) == (128, 64)
    assert TE.EngineConfig().block_k == JE.EngineConfig().block_k
    for bad in (dict(block_k=0), dict(block_m=-1), dict(block_k=1.5)):
        with pytest.raises(ValueError):
            TE.EngineConfig(**bad)


@pytest.mark.parametrize("counts", [False, True])
def test_spike_linear_takes_the_decoded_kernel(counts):
    """spike_linear under sparse='decoded' equals JAX's (interpret-mode
    gather kernel) bitwise on dyadic weights, spikes or counts."""
    rng = np.random.default_rng(5)
    s = _ragged(rng, 2 * 3 * 10, 40).reshape(2, 3, 10, 40)
    if counts:
        s = s * rng.integers(1, 17, s.shape).astype(np.float32)
    w = dyadic(rng, (40, 24))
    jeng = JE.EngineConfig(mode="sparse", sparse="decoded", block_m=16,
                           block_n=16, block_k=16)
    teng = TE.EngineConfig(mode="sparse", sparse="decoded", block_m=16,
                           block_k=16)
    want = np.asarray(JE.spike_linear({"w": jnp.asarray(w)}, jnp.asarray(s),
                                      engine=jeng, counts=counts))
    got = TE.spike_linear({"w": torch.from_numpy(w)}, torch.from_numpy(s),
                          engine=teng, counts=counts)
    np.testing.assert_array_equal(got.numpy(), want)


# --- the fused layer, decoded -------------------------------------------------

# (t, b, l, d, heads, hd, ff, l_block, c_block): one L-block, several with
# a ragged last one, several decoded chunks
LAYER_SHAPES = {"one_block": (2, 2, 16, 64, 4, 16, 128, 16, 128),
                "ragged_blocks": (2, 2, 13, 16, 2, 8, 21, 8, 8),
                "chunks": (2, 3, 16, 64, 4, 16, 128, 8, 16)}


def _kw(heads, hd):
    return dict(family="bn", num_heads=heads, head_dim=hd,
                scale=1.0 / math.sqrt(hd))


@pytest.mark.parametrize("shape", list(LAYER_SHAPES))
def test_decoded_layer_bitwise_against_jitted_jax_oracle(shape):
    t, b, l, d, heads, hd, ff, l_block, c_block = LAYER_SHAPES[shape]
    args = layer_ops(17, t, b, l, d, heads, hd, ff, scales=True)
    scfg = JSpikingConfig(time_steps=t)
    want = np.asarray(jax.jit(lambda *a: JFL.reference_layer(
        *a, scfg, **_kw(heads, hd)))(*args))
    targs = to_torch(args)
    out, cnt = TFL.fused_layer(*targs, sparse="decoded", l_block=l_block,
                               c_block=c_block, **_kw(heads, hd))
    assert np.isfinite(want).all() and want.std() > 0
    np.testing.assert_array_equal(out.numpy(), want)
    # q/k/v: executed gather chunks, from JAX's staging capacities
    _, _, caps, cb = JSD.slab_decode(jnp.asarray(args[1]), l_block=l_block,
                                     c_block=c_block)
    nc = -(-d // cb)
    chunks = (np.arange(nc)[None, None, None] * cb
              < np.asarray(caps)[..., None]).sum((0, 1, 3))
    for p in range(3):
        np.testing.assert_array_equal(cnt[:, p].numpy(),
                                      np.broadcast_to(chunks, (heads, len(
                                          chunks))))
    # every other phase counts as in the tile variant
    _, tile_cnt = TFL.fused_layer(*targs, sparse="tile", l_block=l_block,
                                  **_kw(heads, hd))
    np.testing.assert_array_equal(cnt[:, 3:].numpy(), tile_cnt[:, 3:].numpy())
    assert cnt.dtype == torch.int32 and cnt[:, :3].sum() > 0
    if shape == "chunks":                      # some chunk is skipped
        assert chunks.sum() < nc * t * b * len(chunks)


def test_decoded_layer_all_zero_input_executes_no_chunk():
    t, b, l, d, heads, hd, ff, l_block, c_block = LAYER_SHAPES["ragged_blocks"]
    args = layer_ops(3, t, b, l, d, heads, hd, ff)
    args = (np.zeros_like(args[0]), np.zeros_like(args[1])) + args[2:]
    targs = to_torch(args)
    out, cnt = TFL.fused_layer(*targs, sparse="decoded", l_block=l_block,
                               c_block=c_block, **_kw(heads, hd))
    tile, _ = TFL.fused_layer(*targs, l_block=l_block, **_kw(heads, hd))
    np.testing.assert_array_equal(out.numpy(), tile.numpy())
    np.testing.assert_array_equal(cnt[:, :3].numpy(), 0)


def test_decoded_layer_wrapper_launches_nothing_on_cpu():
    t, b, l, d, heads, hd, ff, l_block, c_block = LAYER_SHAPES["ragged_blocks"]
    targs = to_torch(layer_ops(5, t, b, l, d, heads, hd, ff))
    TFL.fused_layer(*targs, sparse="decoded", l_block=l_block,
                    c_block=c_block, **_kw(heads, hd))
    assert TFL.LAUNCHES == {"fused_layer": 0, "fused_layer_decoded": 0,
                            "fused_layer_rope": 0, "fused_layer_pipeline": 0,
                            "fused_layer_pipeline_decoded": 0,
                            "fused_layer_pipeline_rope": 0,
                            "fused_layer_analog": 0,
                            "fused_layer_decoded_analog": 0,
                            "fused_layer_rope_analog": 0,
                            "fused_layer_pipeline_analog": 0,
                            "fused_layer_pipeline_decoded_analog": 0,
                            "fused_layer_pipeline_rope_analog": 0}
