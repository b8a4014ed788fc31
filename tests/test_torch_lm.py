"""The port's spikingformer-lm (``repro_torch.models.transformer``, the
engine's ``layer_step_causal``, the fused layer's rope family, bitpack and
the nn subset) against the JAX package, at the SMOKE size.

Tolerances, and why:
* bitwise where every sum is exact and both sides round alike: bitpack,
  RoPE's rotation on a shared table (the port follows XLA's FMA
  contraction), the rope-family bundle on dyadic inputs, the plain
  version's sequential product against a numpy loop, the packed KV
  cache's words;
* ``rmsnorm`` within 1e-6 relative: ``torch.rsqrt`` and XLA's rsqrt
  differ by up to 2 ulp (ROADMAP queue 3), and the mean sums in another
  order; the port's RoPE table within 1 ulp of XLA's fp32 cos / sin;
* whole layers, forwards and decode logits within 1e-5 absolute: the
  analog projections sum in another order than XLA's dot and the norms
  carry the rsqrt gap; no LIF spike flips at these sizes (asserted for
  the layer).

The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import bitpack as JB  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core.spiking import SpikingConfig as JSpikingConfig  # noqa: E402
from repro.core.spiking import lif_scan as jlif_scan  # noqa: E402
from repro.kernels import fused_layer as JFL  # noqa: E402
from repro.kernels import fused_ssa as JFS  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.quant import quantize_tree as jquantize_tree  # noqa: E402
from repro.sim.balance_sim import binary_block_schedule  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from _torch_train_helpers import FAMILY_ARCHS, family_batch  # noqa: E402
from repro_torch.core import bitpack as TB  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core.spiking import SpikingConfig  # noqa: E402
from repro_torch.kernels import fused_layer as TFL  # noqa: E402
from repro_torch.kernels import fused_ssa as TFS  # noqa: E402
from repro_torch.kernels import spike_attention as SA  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.quant import quantize_tree  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from _torch_helpers import dyadic, to_torch  # noqa: E402

ARCH = "spikingformer-lm"
# (t, b, l, d, heads, hd, ff, l_block): non-divisible L against l_block=8
# and the SMOKE width
SHAPES = {"odd": (2, 2, 13, 16, 2, 8, 24, 8),
          "smoke": (2, 2, 16, 64, 4, 16, 128, 16)}


def _table(l, hd):
    """The RoPE table as the port forms it, for both packages."""
    cos, sin = nn.rope_table(torch.arange(l), hd, 10000.0)
    return np.stack([cos.numpy(), sin.numpy()])


def rope_layer_ops(seed, t, b, l, d, heads, hd, ff, *, scales=True):
    """Rope-family operands as numpy arrays: dyadic residual stream with
    an all-zero token, dyadic projection input (so the q/k/v sums are
    exact in any order), dyadic weights (or int8 codes with dyadic
    scales), the port's table, a dyadic ln2 scale."""
    rng = np.random.default_rng(seed)
    q_dim = heads * hd
    x = dyadic(rng, (t, b, l, d), bits=6) * 2
    s = dyadic(rng, (t, b, l, d), bits=5) * 2
    x[:, :, min(2, l - 1)] = 0.0
    s[:, :, min(2, l - 1)] = 0.0
    w3 = dyadic(rng, (3, d, q_dim)) * 2
    wo = dyadic(rng, (q_dim, d)) * 0.25
    w1 = dyadic(rng, (d, ff)) * 0.5
    w2 = dyadic(rng, (ff, d)) * 0.25
    sc = None
    if scales:
        sc = tuple(1.0 + dyadic(rng, n, bits=4) * 0.5
                   for n in ((3, q_dim), (d,), (ff,), (d,)))
    auxo = (1.0 + dyadic(rng, (1, d), bits=4) * 0.25).astype(np.float32)
    return (x, s, w3, wo, w1, w2, sc, _table(l, hd), auxo, None, None,
            np.float32(0.3))


def _kw(heads, hd, causal=True):
    return dict(family="rope", num_heads=heads, head_dim=hd,
                scale=1.0 / math.sqrt(hd), causal=causal)


def _jax_spikes(args, t, heads, hd):
    """(q, k, v) spikes of the jitted JAX composition (reference_bundle's
    projection, RoPE and LIF), for the occupancy twin."""
    scfg = JSpikingConfig(time_steps=t)
    half = hd // 2

    @jax.jit
    def proj(s, w3, sc3, aux):
        out = []
        for j in range(3):
            y = (jnp.dot(s, w3[j], preferred_element_type=jnp.float32)
                 * sc3[j]).astype(s.dtype)
            if j < 2:
                y5 = y.reshape(*y.shape[:3], heads, hd)
                cos = aux[0][None, None, :, None, :]
                sin = aux[1][None, None, :, None, :]
                x1, x2 = y5[..., :half], y5[..., half:]
                y = jnp.concatenate([x1 * cos - x2 * sin,
                                     x2 * cos + x1 * sin], -1
                                    ).reshape(y.shape)
            out.append(jlif_scan(y, scfg)[0])
        return tuple(out)
    return [np.asarray(u) for u in proj(args[1], args[2], args[6][0],
                                        args[7])]


# ---------------------------------------------------------------------------
# substrate: bitpack, rmsnorm, rope, embed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 32, 48, 70])
def test_bitpack_matches_jax(n):
    rng = np.random.default_rng(n)
    a = (rng.random((3, 5, n)) < 0.5).astype(np.float32)
    b = (rng.random((3, 7, n)) < 0.5).astype(np.float32)
    a[0, 0] = 1.0                        # every bit set, bit 31 included
    pa, pb = JB.pack_bits(jnp.asarray(a)), JB.pack_bits(jnp.asarray(b))
    ta, tb = TB.pack_bits(torch.from_numpy(a)), TB.pack_bits(
        torch.from_numpy(b))
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy().view(np.uint32), np.asarray(pa))
    np.testing.assert_array_equal(TB.unpack_bits(ta, n).numpy(), a)
    np.testing.assert_array_equal(
        TB.popcount_matmul(ta, tb).numpy(),
        np.asarray(JB.popcount_matmul(pa, pb)))
    assert int(TB.popcount(ta)) == int(JB.popcount(pa)) == int(a.sum())
    with pytest.raises(ValueError):
        TB.unpack_bits(ta, n + 32)


def test_rmsnorm_matches_jax_within_the_rsqrt_gap():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 9, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, s: jnn.rmsnorm({"scale": s}, x))(
        x, scale))
    got = nn.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # the fused layer's ln2 (pairwise tree, float64 rsqrt) sits within the
    # same gap of both
    tree = TFL._rms_plain(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    np.testing.assert_allclose(tree.numpy(), want, rtol=1e-6, atol=0)


def test_rms_plain_sums_squares_as_a_pairwise_tree():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 48)).astype(np.float32)   # D -> P = 64
    v = np.concatenate([x * x, np.zeros((3, 16), np.float32)], -1)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[:, :h] + v[:, h:]
    var = v / np.float32(48) + np.float32(1e-6)
    rs = (1.0 / np.sqrt(var.astype(np.float64))).astype(np.float32)
    want = x * rs
    got = TFL._rms_plain(torch.from_numpy(x), torch.ones(48), 1e-6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_seq_matmul_sums_in_ascending_k():
    rng = np.random.default_rng(2)
    u = rng.standard_normal((5, 33)).astype(np.float32)
    w = rng.standard_normal((33, 7)).astype(np.float32)
    acc = np.zeros((5, 7), np.float32)
    for k in range(33):
        acc = acc + u[:, k:k + 1] * w[k]
    np.testing.assert_array_equal(
        TFL._seq_matmul(torch.from_numpy(u), torch.from_numpy(w)).numpy(),
        acc)


def test_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 4, 16)).astype(np.float32)
    pos = np.arange(11)
    table = _table(11, 16)
    # on a shared table the rotation is bitwise: the port follows XLA's
    # contraction fma(x1, cos, -(x2 sin)), fma(x2, cos, x1 sin)
    want = np.asarray(jax.jit(lambda y, c, s: jnp.concatenate(
        [y[..., :8] * c - y[..., 8:] * s, y[..., 8:] * c + y[..., :8] * s],
        -1))(x, table[0][None, :, None], table[1][None, :, None]))
    got = nn.rope_rotate(torch.from_numpy(x),
                         torch.from_numpy(table[0])[None, :, None],
                         torch.from_numpy(table[1])[None, :, None])
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's table (float64 cos / sin rounded once) is within an ulp
    # of XLA's fp32 cos / sin, so nn.rope is within 2 ulp of |x|
    want = np.asarray(jax.jit(lambda y: jnn.rope(y, jnp.asarray(pos),
                                                 10000.0))(x))
    got = nn.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * np.abs(x).max() * 2.0 ** -24)


def test_embed_and_unembed_match_jax():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7))
    x = (rng.integers(-64, 64, (3, 7, 16)) / 64).astype(np.float32)
    p, tp = {"table": jnp.asarray(table)}, {"table": torch.from_numpy(table)}
    np.testing.assert_array_equal(
        nn.embed(tp, torch.from_numpy(ids)).numpy(),
        np.asarray(jnn.embed(p, jnp.asarray(ids))))
    np.testing.assert_array_equal(
        nn.unembed(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jnn.unembed(p, jnp.asarray(x))))


# ---------------------------------------------------------------------------
# the rope family: bundle, layer, plain version, counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_reference_bundle_rope_bitwise_against_jitted_jax(causal):
    t, b, l, d, heads, hd, ff, _ = SHAPES["odd"]
    args = rope_layer_ops(5, t, b, l, d, heads, hd, ff)
    scfg = JSpikingConfig(time_steps=t)
    kw = dict(family="rope", num_heads=heads, head_dim=hd,
              scale=1.0 / math.sqrt(hd), causal=causal)
    want = np.asarray(jax.jit(lambda s, w, sc, aux: JFS.reference_bundle(
        s, w, sc, aux, 0.3, scfg, **kw))(args[1], args[2], args[6][0],
                                         args[7]))
    got = TFS.reference_bundle(*to_torch((args[1], args[2], args[6][0],
                                          args[7])), 0.3,
                               SpikingConfig(time_steps=t), **kw)
    assert want.std() > 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scales", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_rope_layer_against_jitted_jax_oracle(shape, scales):
    """The port's oracle and the plain version of the kernel against the
    jitted JAX ``reference_layer``: within 1e-5 (ln2's rsqrt and the up
    projection's sum order), with no hidden or output spike flipped."""
    t, b, l, d, heads, hd, ff, l_block = SHAPES[shape]
    args = rope_layer_ops(7, t, b, l, d, heads, hd, ff, scales=scales)
    scfg = JSpikingConfig(time_steps=t)
    want = np.asarray(jax.jit(lambda *a: JFL.reference_layer(
        *a, scfg, **_kw(heads, hd)))(*args))
    targs = to_torch(args)
    ref = TFL.reference_layer(*targs, SpikingConfig(time_steps=t),
                              **_kw(heads, hd)).numpy()
    out, cnt = TFL.fused_layer(*targs, l_block=l_block, **_kw(heads, hd))
    assert np.isfinite(want).all() and want.std() > 0
    for got in (ref, out.numpy()):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(
            jlif_scan(jnp.asarray(got), scfg)[0],
            jlif_scan(jnp.asarray(want), scfg)[0])
    assert cnt.shape == (heads, 8, -(-l // l_block))
    assert cnt.dtype == torch.int32


@pytest.mark.parametrize("shape", list(SHAPES))
def test_rope_layer_counts_follow_the_kernel_predicates(shape):
    t, b, l, d, heads, hd, ff, l_block = SHAPES[shape]
    args = rope_layer_ops(9, t, b, l, d, heads, hd, ff)
    _, cnt = TFL.fused_layer(*to_torch(args), l_block=l_block,
                             **_kw(heads, hd))
    cnt = cnt.numpy()
    nlb = -(-l // l_block)
    s = args[1]
    live = np.array([[[s[ti, bi, lb * l_block:(lb + 1) * l_block].any()
                       for lb in range(nlb)] for bi in range(b)]
                     for ti in range(t)])
    for p in range(3):          # q, k, v: one sub-block per live L-block
        np.testing.assert_array_equal(
            cnt[:, p], np.broadcast_to(live.sum((0, 1)), (heads, nlb)))
    # qkt / qktv: the occupancy twin on the JAX projection spikes; the
    # causal mask does not change which blocks execute (as in JAX)
    _, ksp, vsp = _jax_spikes(args, t, heads, hd)
    pred = binary_block_schedule(ksp, vsp, heads, l_block, 0.3)
    assert pred.sum() > 0
    np.testing.assert_array_equal(cnt[:, 3:5], pred)
    # up: the analog ln2 rows of every L-block are live; wo, down <= t*b
    np.testing.assert_array_equal(cnt[:, 6], t * b)
    assert (cnt[:, 5] <= t * b).all() and (cnt[:, 7] <= t * b).all()
    # delta <= 0 forces every score block (the delta rule)
    args0 = args[:-1] + (np.float32(-0.5),)
    _, cnt0 = TFL.fused_layer(*to_torch(args0), l_block=l_block,
                              **_kw(heads, hd))
    np.testing.assert_array_equal(cnt0.numpy()[:, 3], t * b)


def test_rope_decoded_takes_the_tile_projection():
    """JAX degenerates 'decoded' to the tile skip for the analog rope
    input; so does the port (same output, same counts)."""
    t, b, l, d, heads, hd, ff, l_block = SHAPES["odd"]
    targs = to_torch(rope_layer_ops(3, t, b, l, d, heads, hd, ff))
    tile = TFL.fused_layer(*targs, l_block=l_block, **_kw(heads, hd))
    dec = TFL.fused_layer(*targs, l_block=l_block, sparse="decoded",
                          **_kw(heads, hd))
    for a, c in zip(tile, dec):
        assert torch.equal(a, c)


def test_rope_launcher_rejects_operands_before_launching():
    """Launch A holds a row's q or k bits in at most four words: head_dim
    136 raises before the kernel is built, here too (launch A takes any
    sequence length, launch B any D)."""
    d, ff, heads, hd, l = 16, 16, 1, 136, 13
    args = rope_layer_ops(1, 2, 1, l, d, heads, hd, ff)
    pargs, kw = TFL.prepare(*to_torch(args), **dict(
        _kw(heads, hd), decay=0.5, v_th=1.0, soft_reset=False,
        eps=1e-5, l_block=8))
    with pytest.raises(ValueError):
        TFL.fused_layer_cuda(*pargs, **kw)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------


def _params():
    cfg = jget_config(ARCH, smoke=True)
    jp = jax.tree_util.tree_map(np.asarray,
                                jregistry.init(cfg, jax.random.PRNGKey(0)))
    return cfg, get_config(ARCH, smoke=True), jp


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_init_layout_matches_jax():
    jcfg, cfg, jp = _params()
    tp = registry.init(cfg, 0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = tree_leaves(_sorted(tp))
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        assert a.shape == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


@pytest.mark.parametrize("weights", ["fp32", "int8", "int4"])
def test_forward_matches_jax(weights):
    """The SMOKE forward (fp32 activations) against ``registry.forward``
    (whose eligible layers run the JAX oracle), with ``overlap='off'``
    (the port's oracle) and ``'fused'`` (the kernel's plain version)."""
    jcfg, cfg, jp = _params()
    if weights != "fp32":
        jp = jax.tree_util.tree_map(np.asarray, jquantize_tree(jp, weights))
    toks = _tokens(jcfg, 2, 11)
    want = np.asarray(jax.jit(lambda p, t: jregistry.forward(
        p, jcfg, {"tokens": t})[0])(jp, toks))
    tp = interop.to_torch(jp, device="cpu")
    assert want.std() > 0
    for overlap in ("off", "fused"):
        c = cfg.replace(engine=cfg.engine.replace(overlap=overlap,
                                                  weights=weights))
        got = steps.build_prefill_step(c, device="cpu")(
            tp, {"tokens": torch.from_numpy(toks)})
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=overlap)


def test_prefill_step_quantizes_like_jax_and_matches():
    """The port's own quantizer on the JAX params, through the port's
    prefill step, against JAX's prefill step on JAX's quantized tree."""
    jcfg, cfg, jp = _params()
    toks = _tokens(jcfg, 2, 9, seed=1)
    want = np.asarray(jax.jit(jsteps.build_prefill_step(jcfg))(
        jquantize_tree(jp, "int8"), {"tokens": toks}))
    tq = quantize_tree(interop.to_torch(jp, device="cpu"), "int8")
    got = steps.build_prefill_step(cfg, device="cpu")(
        tq, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_decode_steps_match_jax_token_by_token(weights):
    """Token-by-token decode from an empty cache, then a 3-token chunked
    bite: logits within 1e-5 and the packed cache's words, bit for bit."""
    jcfg, cfg, jp = _params()
    if weights == "int8":
        jp = jax.tree_util.tree_map(np.asarray, jquantize_tree(jp, "int8"))
    tp = interop.to_torch(jp, device="cpu")
    toks = _tokens(jcfg, 2, 8, seed=2)
    jstep = jax.jit(jsteps.build_batched_serve_step(jcfg))
    tstep = steps.build_batched_serve_step(cfg, device="cpu")
    jcache = jregistry.init_cache(jcfg, 2, 16)
    tcache = registry.init_cache(cfg, 2, 16, device="cpu")
    bites = [(i, 1) for i in range(5)] + [(5, 3)]
    for p0, c in bites:
        tk = toks[:, p0:p0 + c]
        pos = np.full(2, p0, np.int32)
        n_tok = np.array([c, max(1, c - 1)], np.int32)   # a padded row
        want, jcache = jstep(jp, jcache, tk, pos, n_tok)
        got, tcache = tstep(tp, tcache, torch.from_numpy(tk),
                            torch.from_numpy(pos), torch.from_numpy(n_tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_array_equal(
            tcache["layers"][key].numpy().view(np.uint32),
            np.asarray(jcache["layers"][key]))
    np.testing.assert_array_equal(tcache["layers"]["pos"].numpy(),
                                  np.asarray(jcache["layers"]["pos"]))
    # invalidating slot 0 resets only its tags
    TT.invalidate_slots(tcache, torch.tensor([True, False]))
    tags = tcache["layers"]["pos"].numpy()
    assert (tags[:, 0] == -1).all()
    np.testing.assert_array_equal(tags[:, 1],
                                  np.asarray(jcache["layers"]["pos"])[:, 1])


def test_serve_step_matches_jax():
    """The one-token serve step (a scalar position for every slot)."""
    jcfg, cfg, jp = _params()
    tp = interop.to_torch(jp, device="cpu")
    toks = _tokens(jcfg, 2, 3, seed=4)
    jstep = jax.jit(jsteps.build_serve_step(jcfg))
    tstep = steps.build_serve_step(cfg, device="cpu")
    jcache = jregistry.init_cache(jcfg, 2, 8)
    tcache = registry.init_cache(cfg, 2, 8, device="cpu")
    for i in range(3):
        want, jcache = jstep(jp, jcache, toks[:, i:i + 1], np.int32(i))
        got, tcache = tstep(tp, tcache, torch.from_numpy(toks[:, i:i + 1]),
                            i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _layer_inputs(cfg, dtype=torch.float32):
    jcfg, _, jp = _params()
    tp = interop.to_torch(jp, device="cpu")
    lp = TT._layer(tp, 0)
    x = torch.randn((cfg.spiking.time_steps, 2, 12, cfg.d_model),
                    generator=torch.Generator().manual_seed(0)) * 0.5
    return lp, x.to(dtype), torch.arange(12)


def test_layer_step_causal_dispatch(monkeypatch):
    cfg = get_config(ARCH, smoke=True)
    lp, x, pos = _layer_inputs(cfg)
    # fp32 (and all-quantized) layers are eligible; 'auto' on the analog
    # ln1 output resolves 'tile' and is counted
    E.reset_sparse_decisions()
    eng = cfg.engine.replace(overlap="fused", sparse="auto")
    before = dict(TFL.LAUNCHES)
    y = E.layer_step_causal(lp, cfg, x, pos, engine=eng)
    assert E.SPARSE_DECISIONS == {"tile": 1, "decoded": 0}
    assert TFL.LAUNCHES == before          # CPU: the plain version
    ref = E.layer_step_causal(lp, cfg, x, pos,
                              engine=eng.replace(overlap="off"))
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    # a bf16 unquantized layer is not eligible: the sequential
    # composition, whose causal attention is the spike_attention wrapper
    calls = []
    real = SA.spike_attention

    def spy(*a, **kw):
        calls.append(kw["causal"])
        return real(*a, **kw)
    monkeypatch.setattr("repro_torch.kernels.ops.spike_attention", spy)
    bcfg = cfg.replace(dtype="bfloat16")
    blp = {k: v for k, v in lp.items()}
    E.layer_step_causal(blp, bcfg, x.bfloat16(), pos,
                        engine=eng.replace(binary="mxu_kernel"))
    assert calls == [True]


def _select_qkv(path):
    """The mixed LM tree: int8 wq, wk, wv; every other linear fp."""
    return path.rsplit("/", 1)[-1] in ("wq", "wk", "wv")


def test_mixed_tree_bundle_fused_matches_off_and_jax(monkeypatch):
    """The mixed int8 LM tree (int8 wq, wk, wv) at SMOKE size: its layers
    are not eligible for the layer program (mixed quantization) and its
    bundles are eligible for the bundle kernel's rope family (#6b).
    ``ssa_step_causal`` under overlap='fused' (the plain version on the
    CPU, one bundle call, no launch) equals 'off' (the sequential
    composition) bitwise: the projections sum in another order, and no
    LIF decision flips at this size (asserted). The prefill step's
    logits under 'fused' equal 'off' bitwise, and JAX's forward of the
    same tree within 1e-5 absolute (the norms' rsqrt gap, ROADMAP queue
    3, as the other LM forwards)."""
    jcfg, cfg, jp = _params()
    jq = jax.tree_util.tree_map(np.asarray, jquantize_tree(
        jp, "int8", select=_select_qkv))
    tq = interop.to_torch(jq, device="cpu")
    assert "qw" in tq["layers"]["wq"] and "w" in tq["layers"]["wo"]
    toks = _tokens(jcfg, 2, 11, seed=3)
    lp = TT._layer(tq, 0)
    x = nn.embed(tq["embed"], torch.from_numpy(toks))
    x = x[None].expand(cfg.spiking.time_steps, *x.shape)
    h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    pos = torch.arange(toks.shape[1])
    calls = []
    real = TFS.fused_ssa

    def spy(*a, **kw):
        calls.append((kw["family"], kw["causal"]))
        return real(*a, **kw)
    monkeypatch.setattr(TFS, "fused_ssa", spy)
    before = dict(TFS.LAUNCHES)
    fused = E.ssa_step_causal(lp, cfg, h, pos,
                              engine=cfg.engine.replace(overlap="fused"))
    off = E.ssa_step_causal(lp, cfg, h, pos,
                            engine=cfg.engine.replace(overlap="off"))
    assert calls == [("rope", True)] and TFS.LAUNCHES == before
    assert torch.equal(fused, off) and float(fused.sum()) > 0
    want = np.asarray(jax.jit(lambda p, t: jregistry.forward(
        p, jcfg, {"tokens": t})[0])(jq, toks))
    got = {ov: steps.build_prefill_step(
        cfg.replace(engine=cfg.engine.replace(overlap=ov)), device="cpu")(
            tq, {"tokens": torch.from_numpy(toks)}) for ov in ("fused", "off")}
    assert len(calls) == 1 + cfg.num_layers
    assert torch.equal(got["fused"], got["off"])
    assert np.isfinite(want).all() and want.std() > 0
    np.testing.assert_allclose(got["fused"].numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", ["moe", "rwkv", "hybrid", "encdec",
                                    "vlm"])
def test_unported_token_paths_raise(family):
    cfg = get_config(ARCH, smoke=True)
    # sliding-window and local/global spiking LMs and the non-spiking
    # dense family, which raised here before they were ported, run
    tokens = {"tokens": torch.zeros((2, 5), dtype=torch.long)}
    for now in (cfg.replace(attn_type="swa", window=3),
                cfg.replace(attn_type="local_global", window=3,
                            global_every=2),
                cfg.replace(spiking=None)):
        logits, _ = registry.forward(registry.init(now, 0, device="cpu"),
                                     now, tokens)
        assert logits.shape == (2, 5, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
    # the MoE, rwkv, hybrid, encdec and vlm families, which raised here
    # before they were ported, run (vlm's logits cover its patches too);
    # the server refuses a mesh that is no launch.mesh.Mesh
    other = get_config(FAMILY_ARCHS[family], smoke=True)
    batch = family_batch(other, 2, 5)
    logits, aux = registry.forward(registry.init(other, 0, device="cpu"),
                                   other, batch)
    n_patch = batch["patch_embeds"].shape[1] if family == "vlm" else 0
    assert logits.shape == (2, 5 + n_patch, other.vocab_size)
    assert bool(torch.isfinite(logits).all())
    if family == "moe":
        assert float(aux["moe_aux"]) > 0
    from repro_torch.launch.serve import BatchedServer
    with pytest.raises(TypeError, match="Mesh"):
        BatchedServer(cfg, registry.init(cfg, 0, device="cpu"), 2, 16,
                      device="cpu", mesh=object())
    lp, x, pos = _layer_inputs(cfg)
    # training the spiking full-attention LM, which raised here before it
    # was ported, runs; so does a sliding-window LM's train step
    y = E.layer_step_causal(lp, cfg, x, pos, train=True)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    from repro_torch.optim import adamw
    tp = registry.init(cfg, 0, device="cpu")
    opt = adamw(1e-3)
    step = steps.build_train_step(cfg.replace(attn_type="swa", window=3),
                                  opt, device="cpu")
    _, _, nstep, m = step(tp, opt.init(tp), 0,
                          {"tokens": np.zeros((2, 5), np.int32)})
    assert nstep == 1 and np.isfinite(float(m["loss"]))
    # the fused bundle's rope family, which raised here before it was
    # ported, now runs: under overlap='fused' equal to 'off', bitwise
    h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    fused = E.ssa_step_causal(lp, cfg, h, pos,
                              engine=cfg.engine.replace(overlap="fused"))
    off = E.ssa_step_causal(lp, cfg, h, pos,
                            engine=cfg.engine.replace(overlap="off"))
    assert torch.equal(fused, off) and float(fused.sum()) > 0
    # the layer program's pipelined rope variant, which raised here
    # before it was ported, equals the fused one
    t, b, l, d, heads, hd, ff, l_block = SHAPES["odd"]
    targs = to_torch(rope_layer_ops(3, t, b, l, d, heads, hd, ff))
    got = TFL.fused_layer(*targs, pipeline=True, **_kw(heads, hd))
    want = TFL.fused_layer(*targs, **_kw(heads, hd))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
