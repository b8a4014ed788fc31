"""Launch A of the port's layer program (``csrc/fused_layer.cu``: the q/k/v
projections, then the binary attention, with the spike bits in device
memory) as far as the CPU can hold it.

* the launcher's bounds: launch A takes any L (the LM's rope layer at
  3745, 8192 and 16384 tokens, 8-512's layer at L 1409 and 4096, in bf16
  and fp32: past what the earlier shared-memory layout took) and
  head_dim a multiple of 8 up to 128, and refuses 136 and head_dims off
  the grid (launch B's bounds: ``test_torch_launch_b.py``);
* the Python mirrors of the kernel's layouts: ``bits_words`` (the bit
  scratch), ``smem_a`` (a projection block's shared memory) and
  ``column_width`` (the widest w3 column slice that fits), each against
  its formula restated here;
* the plain versions past the old bounds against the JAX package:
  ``fused_ssa_plain`` (rope, causal) and ``fused_layer_plain`` (rope,
  causal) at L 2100, one key past a 2048-key chunk, against jitted JAX
  ``reference_bundle`` (bitwise, dyadic operands) and ``reference_layer``
  (within the rope tests' 1e-5, or 2 ulp of outputs in the hundreds:
  ln2's rsqrt and the up product's sum order, no spike flipped); the bn layer at head_dim 128, tile and
  decoded, bitwise against jitted JAX ``reference_layer``.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.spiking import SpikingConfig as JSpikingConfig  # noqa: E402
from repro.core.spiking import lif_scan as jlif_scan  # noqa: E402
from repro.kernels import fused_layer as JFL  # noqa: E402
from repro.kernels import fused_ssa as JFS  # noqa: E402
from repro_torch.kernels import fused_layer as TFL  # noqa: E402
from repro_torch.kernels import fused_ssa as TFS  # noqa: E402

from _torch_helpers import layer_ops, to_torch  # noqa: E402
from test_torch_lm import rope_layer_ops  # noqa: E402

# (what, T, L, D, heads, head_dim, F, rope): the LM's rope layer and
# 8-512's layer at sequence lengths the shared-memory layout refused (it
# took up to 3744 / 2827 tokens and L 1408 / 480, bf16 / fp32)
LONG = [("lm 3745", 4, 3745, 256, 8, 32, 1024, True),
        ("lm 8192", 4, 8192, 256, 8, 32, 1024, True),
        ("lm 16384", 4, 16384, 256, 8, 32, 1024, True),
        ("8-512 1409", 4, 1409, 512, 8, 64, 2048, False),
        ("8-512 4096", 4, 4096, 512, 8, 64, 2048, False)]


@pytest.mark.parametrize("elem_size", [2, 4])
@pytest.mark.parametrize("case", LONG, ids=[c[0] for c in LONG])
def test_launcher_takes_any_sequence_length(case, elem_size):
    _, t, l, d, heads, hd, ff, rope = case
    nlb = -(-l // 128)
    TFL.check_launch_shapes(elem_size, t, l, d, heads, hd, nlb, rope=rope)
    TFL.check_launch_shapes(elem_size, t, l, d, heads, hd, 1, rope=rope,
                            what="fused_ssa")
    # the bit scratch of the sequence: a few MB where the old layout held
    # it in one block's 227 KB
    assert TFL.bits_words(t, 1, l, heads, hd, nlb) * 4 < 8 << 20


@pytest.mark.parametrize("head_dim,ok", [(72, True), (96, True), (128, True),
                                         (136, False), (12, False),
                                         (76, False)])
def test_launcher_takes_head_dim_up_to_128(head_dim, ok):
    """A row's q or k bits in up to four 32-bit words: head_dim a multiple
    of 8 up to 128 (bn and rope, bf16 and fp32, the layer and the
    bundle); past 128 or off the grid refused before anything is built."""
    for es in (2, 4):
        for rope in (False, True):
            calls = (lambda: TFL.check_launch_shapes(  # noqa: E731
                         es, 4, 100, 256, 2, head_dim, 2, rope=rope),
                     lambda: TFL.check_launch_shapes(  # noqa: E731
                         es, 4, 100, 256, 2, head_dim, 1, rope=rope,
                         what="fused_ssa"))
            for call in calls:
                if ok:
                    call()
                else:
                    with pytest.raises(ValueError, match="head_dim a "
                                       "multiple of 8 up to 128"):
                        call()


def _padded(n, es):
    units = n * es // 16
    return n + (16 // es if units % 2 == 0 else 32 // es)


# (elem_size, T, B, L, D, heads, head_dim, rope, cw): the widest column
# slice that fits one block, restated: whole groups dividing the 3 H
# groups up to 128 columns, else a pair slice of one group
MIRRORS = [(2, 4, 8, 512, 256, 8, 32, True, 128),
           (4, 4, 8, 512, 256, 8, 32, True, 128),
           (2, 4, 32, 196, 512, 8, 64, False, 128),
           (4, 4, 32, 196, 512, 8, 64, False, 64),
           (2, 4, 64, 64, 256, 8, 32, False, 128),
           (2, 4, 4, 100, 256, 2, 128, False, 128),
           (4, 4, 4, 100, 256, 2, 128, True, 128),
           (2, 2, 2, 13, 16, 2, 8, False, 48),
           (2, 4, 1, 4096, 1024, 8, 128, True, 32),
           (4, 4, 1, 3000, 2048, 8, 64, False, 16)]


@pytest.mark.parametrize("case", MIRRORS,
                         ids=[f"{c[0]}-{c[3]}-{c[4]}-{c[6]}-{c[7]}"
                              for c in MIRRORS])
def test_launch_a_layout_mirrors_match_their_formulas(case):
    es, t, b, l, d, heads, hd, rope, cw = case
    assert TFL.column_width(es, d, heads, hd, rope) == cw
    widths = TFL.column_widths(heads, hd)
    assert widths == sorted(widths, reverse=True)
    for w in widths:
        assert w % 8 == 0 and w <= TFL.CW_MAX
        assert (w % hd == 0 and (3 * heads) % (w // hd) == 0) if w >= hd \
            else hd % w == 0
    # SmemP: the w3 slice ([D][cw padded] in the dtype; rope: [cw][D + 4]
    # fp32), SA slab chunks of MA rows x 256 bytes (padded), rope's fp32
    # projections, the q / k words and v masks, two 16-byte vectors a
    # column
    kca = 256 // es
    w = cw * (d + 4) * 4 if rope else d * _padded(cw, es) * es
    ring = 3 * 64 * _padded(kca, es) * es
    ngw = (cw // hd if cw >= hd else 1) * -(-hd // 32)
    total = (-(-w // 16) * 16 + ring + (64 * cw * 4 if rope else 0)
             + -(-64 * ngw * 4 // 16) * 16 + cw * 8 + cw * 32)
    assert TFL.smem_a(es, d, hd, cw, rope) == total <= TFL.SMEM_LIMIT
    wider = [x for x in widths if x > cw]
    assert all(TFL.smem_a(es, d, hd, x, rope) > TFL.SMEM_LIMIT
               for x in wider)
    # BitsLayout: q and k (T, B, H, L, hw) words, v (T, B, H, hd, lw),
    # the key / value L-block flags (T, B, H, nlb), the projection flags
    # (T, B, nlb)
    nlb = -(-l // 128)
    hw, lw = -(-hd // 32), -(-l // 32)
    assert TFL.bits_words(t, b, l, heads, hd, nlb) == (
        2 * t * b * heads * l * hw + t * b * heads * hd * lw
        + 2 * t * b * heads * nlb + t * b * nlb)


# the narrow rope width past a 2048-key chunk: (T, B, L, D, H, hd, F)
ROPE_LONG = (2, 1, 2100, 64, 2, 32, 128)


def _rope_kw(heads, hd):
    return dict(family="rope", num_heads=heads, head_dim=hd,
                scale=1.0 / math.sqrt(hd), causal=True)


def test_rope_bundle_past_a_key_chunk_bitwise_against_jitted_jax():
    """``fused_ssa_plain`` (rope, causal) at L 2100 on dyadic currents and
    weights == jitted JAX ``reference_bundle``, bitwise; its (H, 4)
    counts are the whole-slab closed form."""
    t, b, l, d, heads, hd, ff = ROPE_LONG
    args = rope_layer_ops(21, t, b, l, d, heads, hd, ff)
    s, w3, sc3, table = args[1], args[2], args[6][0], args[7]
    kw = _rope_kw(heads, hd)
    want = np.asarray(jax.jit(lambda *a: JFS.reference_bundle(
        *a, 0.3, JSpikingConfig(time_steps=t), **kw))(s, w3, sc3, table))
    got, cnt = TFS.fused_ssa_plain(*to_torch((s, w3, sc3, table)), 0.3, **kw)
    assert want.std() > 0
    np.testing.assert_array_equal(got.numpy(), want)
    assert cnt[0].tolist() == [t * b] * 3 + [2 * t * b]


def test_rope_layer_past_a_key_chunk_against_jitted_jax():
    """``fused_layer_plain`` (rope, causal) at L 2100 against jitted JAX
    ``reference_layer``: within 1e-5 or 2 ulp of the value (ln2's rsqrt
    and the up product's sum order, as the rope layer tests; the causal
    contexts count up to 2100 keys here, so outputs reach the hundreds,
    where an fp32 ulp is 6.1e-5), no output spike flipped."""
    t, b, l, d, heads, hd, ff = ROPE_LONG
    args = rope_layer_ops(22, t, b, l, d, heads, hd, ff)
    scfg = JSpikingConfig(time_steps=t)
    want = np.asarray(jax.jit(lambda *a: JFL.reference_layer(
        *a, scfg, **_rope_kw(heads, hd)))(*args))
    out, cnt = TFL.fused_layer(*to_torch(args), l_block=128,
                               **_rope_kw(heads, hd))
    assert np.isfinite(want).all() and want.std() > 0
    np.testing.assert_allclose(out.numpy(), want, rtol=2.0 ** -22, atol=1e-5)
    np.testing.assert_array_equal(jlif_scan(jnp.asarray(out.numpy()), scfg)[0],
                                  jlif_scan(jnp.asarray(want), scfg)[0])
    assert cnt.shape == (heads, 8, -(-l // 128))


@pytest.mark.parametrize("sparse", ["tile", "decoded"])
def test_bn_layer_at_head_dim_128_bitwise_against_jitted_jax(sparse):
    """The bn layer at head_dim 128 (four words a row of q or k bits; T 2,
    B 2, L 50, D 256, 2 heads, F 256) on dyadic weights: the plain
    version, tile and decoded, == jitted JAX ``reference_layer``."""
    t, b, l, d, heads, hd, ff = 2, 2, 50, 256, 2, 128, 256
    args = layer_ops(23, t, b, l, d, heads, hd, ff)
    kw = dict(family="bn", num_heads=heads, head_dim=hd,
              scale=1.0 / math.sqrt(hd))
    want = np.asarray(jax.jit(lambda *a: JFL.reference_layer(
        *a, JSpikingConfig(time_steps=t), **kw))(*args))
    out, cnt = TFL.fused_layer(*to_torch(args), l_block=32, sparse=sparse,
                               **kw)
    assert np.isfinite(want).all() and want.std() > 0
    np.testing.assert_array_equal(out.numpy(), want)
    assert cnt.shape == (heads, 8, 2) and int(cnt[:, 3].sum()) > 0
