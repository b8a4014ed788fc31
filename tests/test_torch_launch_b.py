"""Launch B of the port's layer program (``csrc/fused_layer.cu``: wo, the
rope family's ln2, up and down as kernels over the whole card, the
input-neuron and hidden spikes as bits in device memory) as far as the
CPU can hold it.

* the launcher's bounds: launch B takes any T (its blocks hold groups of
  timesteps), any number of heads (its flags are a word a head), any
  rope D (ln2's tree streams a row) and any F (the spike bits live in
  device memory), in bf16 and fp32; launch A's refusals (head_dim past
  128 or off the grid of 8) stay;
* the Python mirrors of launch B's device scratch: ``spike_words`` (the
  spike bits, chunk-major) and ``flag_words`` (the count flags), each
  against its formula restated here;
* the plain versions at the shapes the kernel now takes, against jitted
  JAX ``reference_layer``: the layer at T = 6 (bn tile and decoded
  bitwise on dyadic weights; rope within the rope tests' tolerance), a
  bn layer with 40 heads of 8 (F / H = 16), a rope layer at D = 1040.

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
from repro_torch.kernels import fused_layer as TFL  # noqa: E402

from _torch_helpers import layer_ops, to_torch  # noqa: E402
from test_torch_lm import rope_layer_ops  # noqa: E402

# (what, T, L, D, heads, head_dim, F, rope): shapes the earlier launch B
# refused (T <= 4 fused, at most 32 heads, rope D <= 1024, a tile's spike
# bits within shared memory, F / H a multiple of 8)
WIDER = {"t5": (5, 64, 256, 8, 32, 1024, False),
         "t6": (6, 196, 512, 8, 64, 2048, False),
         "t8": (8, 512, 256, 8, 32, 1024, True),
         "heads33": (4, 64, 256, 33, 8, 33 * 8, False),
         "heads64": (4, 64, 256, 64, 8, 64 * 8, False),
         "rope_d1040": (4, 64, 1040, 8, 32, 1024, True),
         "rope_d2048": (4, 512, 2048, 8, 32, 1024, True),
         "f24576": (4, 196, 512, 8, 64, 24576, False)}
# launch A's refusals, unchanged: (head_dim, match)
REFUSED = {"hd136": 136, "hd12": 12}


@pytest.mark.parametrize("elem_size", [2, 4])
@pytest.mark.parametrize("case", list(WIDER) + list(REFUSED))
def test_launch_b_takes_any_t_heads_rope_d_and_f(case, elem_size):
    """``check_launch_shapes`` accepts the fused layer program at T 5, 6
    and 8, 33 and 64 heads, rope D 1040 and 2048 and 8-512's widths at F
    24576, and still refuses head_dim 136 and 12 (launch A)."""
    if case in REFUSED:
        with pytest.raises(ValueError, match="head_dim a multiple of 8 up "
                                             "to 128"):
            TFL.check_launch_shapes(elem_size, 4, 64, 256, 2, REFUSED[case],
                                    1)
        return
    t, l, d, heads, hd, ff, rope = WIDER[case]
    TFL.check_launch_shapes(elem_size, t, l, d, heads, hd, -(-l // 128),
                            rope=rope)
    # launch B's device scratch for a 32-image / 8-prompt batch: MBs,
    # where the earlier kernel held a tile's bits in shared memory
    assert TFL.spike_words(t, 32 * l, d, ff) * 4 < 1 << 30
    assert TFL.flag_words(t, 32, -(-l // 128), heads) * 4 < 1 << 20


# (T, B L, D, F): 4-256, 8-512 (an odd D / 64), the LM, a ragged SMOKE
# width with an odd row count
SCRATCH = [(4, 4096, 256, 1024), (4, 6272, 512, 2048), (6, 13, 80, 640),
           (1, 104, 64, 128)]


@pytest.mark.parametrize("case", SCRATCH, ids=[str(c) for c in SCRATCH])
def test_launch_b_scratch_mirrors_match_their_formulas(case):
    """``spike_words``: the input neuron's and the hidden spikes, each
    (T, pairs of 64 columns, B L rounded up to even, 2 words);
    ``flag_words``: ctx and hid flags (T, B, nlb, H) and the s2 flags (T,
    B, nlb)."""
    t, m, d, ff = case
    rows = m + m % 2
    assert TFL.spike_words(t, m, d, ff) == (
        t * rows * 2 * math.ceil(d / 64) + t * rows * 2 * math.ceil(ff / 64))
    for b, nlb, heads in ((1, 1, 8), (32, 2, 8), (4, 2, 40)):
        assert TFL.flag_words(t, b, nlb, heads) == (
            2 * t * b * nlb * heads + t * b * nlb)


def _bn_kw(heads, hd):
    return dict(family="bn", num_heads=heads, head_dim=hd,
                scale=1.0 / math.sqrt(hd))


def _rope_kw(heads, hd):
    return dict(family="rope", num_heads=heads, head_dim=hd,
                scale=1.0 / math.sqrt(hd), causal=True)


def _jax_layer(args, t, kw):
    return np.asarray(jax.jit(lambda *a: JFL.reference_layer(
        *a, JSpikingConfig(time_steps=t), **kw))(*args))


# (what, T, B, L, D, heads, head_dim, F, l_block, sparse)
BN_CASES = [("t6 tile", 6, 2, 20, 64, 4, 16, 128, 8, "tile"),
            ("t6 decoded", 6, 2, 20, 64, 4, 16, 128, 8, "decoded"),
            ("heads40 tile", 2, 2, 20, 64, 40, 8, 640, 16, "tile"),
            ("heads40 decoded", 2, 2, 20, 64, 40, 8, 640, 16, "decoded")]


@pytest.mark.parametrize("case", BN_CASES, ids=[c[0] for c in BN_CASES])
def test_bn_layer_past_the_old_bounds_bitwise_against_jitted_jax(case):
    """The bn layer's plain version at T = 6 (two of launch B's groups of
    timesteps) and with 40 heads of 8 (F / H = 16), tile and decoded, on
    dyadic weights: bitwise equal to jitted JAX ``reference_layer``; the
    counts have the layer's shape and every post-attention phase ran."""
    _, t, b, l, d, heads, hd, ff, l_block, sparse = case
    args = layer_ops(31, t, b, l, d, heads, hd, ff)
    want = _jax_layer(args, t, _bn_kw(heads, hd))
    out, cnt = TFL.fused_layer(*to_torch(args), l_block=l_block,
                               sparse=sparse, **_bn_kw(heads, hd))
    assert np.isfinite(want).all() and want.std() > 0
    np.testing.assert_array_equal(out.numpy(), want)
    assert cnt.shape == (heads, 8, -(-l // l_block))
    assert int(cnt[:, 5:].sum()) > 0 and (cnt[:, 5:] <= t * b).all()


# (what, T, B, L, D, heads, head_dim, F, l_block)
ROPE_CASES = [("t6", 6, 1, 16, 64, 2, 32, 128, 8),
              ("d1040", 2, 1, 8, 1040, 2, 16, 64, 8)]


@pytest.mark.parametrize("case", ROPE_CASES, ids=[c[0] for c in ROPE_CASES])
def test_rope_layer_past_the_old_bounds_against_jitted_jax(case):
    """The rope layer's plain version at T = 6 and at D = 1040 (past the
    earlier ln2's 1024 columns in registers) against jitted JAX
    ``reference_layer``: within 1e-5 or 2 ulp (ln2's rsqrt and the up
    product's sum order, as the rope layer tests), no output spike
    flipped."""
    _, t, b, l, d, heads, hd, ff, l_block = case
    args = rope_layer_ops(32, t, b, l, d, heads, hd, ff)
    scfg = JSpikingConfig(time_steps=t)
    want = _jax_layer(args, t, _rope_kw(heads, hd))
    out, cnt = TFL.fused_layer(*to_torch(args), l_block=l_block,
                               **_rope_kw(heads, hd))
    assert np.isfinite(want).all() and want.std() > 0
    np.testing.assert_allclose(out.numpy(), want, rtol=2.0 ** -22, atol=1e-5)
    np.testing.assert_array_equal(jlif_scan(jnp.asarray(out.numpy()), scfg)[0],
                                  jlif_scan(jnp.asarray(want), scfg)[0])
    assert cnt.shape == (heads, 8, -(-l // l_block))
