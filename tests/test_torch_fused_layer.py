"""The port's fused layer program (``repro_torch.kernels.fused_layer``)
against the JAX package.

* the port's ``reference_layer`` and the plain version of its
  ``fused_layer`` (what the wrapper runs on CPU tensors) are bitwise
  equal to the *jitted* JAX ``reference_layer`` on the ``bn`` family —
  the JAX kernel cannot run under the installed jax, and its own tests
  pin it bitwise to that oracle;
* the ``(H, 8, n_l_blocks)`` counts follow the TPU kernel's predicates:
  the binary phases equal ``repro.sim.balance_sim.binary_block_schedule``,
  the projection phases count live spike blocks, and a dark slab or an
  all-zero input gives the closed forms of ``tests/test_fused_layer.py``;
* the wrapper takes the plain version for CPU tensors and launches
  nothing; the pipelined variants run their plain version, equal to the
  fused one (more in ``test_torch_pipeline.py``); the analog-score
  variants run (held against JAX in ``test_torch_analog.py``; the decoded
  variant in ``test_torch_spike_decode.py``, the rope family in
  ``test_torch_lm.py``).

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
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
from repro.sim.balance_sim import binary_block_schedule  # noqa: E402
from repro_torch.core.spiking import SpikingConfig  # noqa: E402
from repro_torch.kernels import fused_layer as TFL  # noqa: E402

from _torch_helpers import layer_ops, to_torch  # noqa: E402

# (t, b, l, d, heads, hd, ff, l_block): non-divisible L against l_block=8
# with d_ff not a multiple of heads (the shape of tests/test_fused_layer),
# and the SMOKE width of spikingformer-4-256
SHAPES = {"odd": (2, 2, 13, 16, 2, 8, 21, 8),
          "smoke": (2, 2, 16, 64, 4, 16, 128, 16)}


def _kw(heads, hd):
    return dict(family="bn", num_heads=heads, head_dim=hd,
                scale=1.0 / math.sqrt(hd))


def _jax_reference(args, t, heads, hd):
    scfg = JSpikingConfig(time_steps=t)
    fn = jax.jit(lambda *a: JFL.reference_layer(*a, scfg, **_kw(heads, hd)))
    return np.asarray(fn(*args))


def _port(args, t, heads, hd, l_block):
    targs = to_torch(args)
    ref = TFL.reference_layer(*targs, SpikingConfig(time_steps=t),
                              **_kw(heads, hd))
    out, cnt = TFL.fused_layer(*targs, l_block=l_block, **_kw(heads, hd))
    return ref.numpy(), out.numpy(), cnt.numpy()


@pytest.mark.parametrize("scales", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_layer_bitwise_against_jitted_jax_oracle(shape, scales):
    t, b, l, d, heads, hd, ff, l_block = SHAPES[shape]
    args = layer_ops(11, t, b, l, d, heads, hd, ff, scales=scales)
    want = _jax_reference(args, t, heads, hd)
    ref, out, cnt = _port(args, t, heads, hd, l_block)
    assert np.isfinite(want).all() and want.std() > 0
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(out, want)
    assert cnt.shape == (heads, 8, -(-l // l_block)) and cnt.dtype == np.int32


@pytest.mark.parametrize("shape", list(SHAPES))
def test_layer_counts_follow_the_kernel_predicates(shape):
    t, b, l, d, heads, hd, ff, l_block = SHAPES[shape]
    args = layer_ops(13, t, b, l, d, heads, hd, ff)
    _, _, cnt = _port(args, t, heads, hd, l_block)
    nlb = -(-l // l_block)
    s = args[1]
    live = np.array([[[s[ti, bi, lb * l_block:(lb + 1) * l_block].any()
                       for lb in range(nlb)] for bi in range(b)]
                     for ti in range(t)])
    # projection phases: one sub-block per live spike L-block, every head;
    # the dark (t=0, b=0) slab is skipped in every block
    for p in range(3):
        np.testing.assert_array_equal(cnt[:, p],
                                      np.broadcast_to(live.sum((0, 1)),
                                                      (heads, nlb)))
    assert (cnt[:, :3] <= t * b - 1).all()
    # binary phases: the numpy twin of the kernel's occupancy map, fed
    # the projection spikes of the jitted JAX composition
    scfg = JSpikingConfig(time_steps=t)

    @jax.jit
    def kv(s, w3, auxp):
        out = []
        for i in (1, 2):
            cur = jnp.dot(s, w3[i], preferred_element_type=jnp.float32)
            y = cur.astype(s.dtype).astype(jnp.float32)
            y = (y - auxp[i, 0]) * jax.lax.rsqrt(auxp[i, 1] + 1e-5)
            y = (y * auxp[i, 2] + auxp[i, 3]).astype(s.dtype)
            out.append(jlif_scan(y, scfg)[0])
        return tuple(out)

    ksp, vsp = kv(s, args[2], args[7])
    pred = binary_block_schedule(np.asarray(ksp), np.asarray(vsp), heads,
                                 l_block, 0.3)
    assert pred.sum() > 0
    np.testing.assert_array_equal(cnt[:, 3:5], pred)
    assert (cnt[:, 5:] <= t * b).all() and cnt[:, 5:].sum() > 0


def test_layer_all_zero_input():
    t, b, l, d, heads, hd, ff, l_block = SHAPES["odd"]
    args = layer_ops(3, t, b, l, d, heads, hd, ff)
    args = (np.zeros_like(args[0]), np.zeros_like(args[1])) + args[2:]
    want = _jax_reference(args, t, heads, hd)
    ref, out, cnt = _port(args, t, heads, hd, l_block)
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(out, want)
    # every projection slab dark -> no executed projection sub-block
    np.testing.assert_array_equal(cnt[:, :3], 0)


def test_wrapper_runs_plain_version_on_cpu_and_launches_nothing():
    t, b, l, d, heads, hd, ff, l_block = SHAPES["odd"]
    targs = to_torch(layer_ops(5, t, b, l, d, heads, hd, ff))
    before = TFL.LAUNCHES["fused_layer"]
    out, cnt = TFL.fused_layer(*targs, l_block=l_block, **_kw(heads, hd))
    assert TFL.LAUNCHES["fused_layer"] == before
    assert out.device.type == "cpu" and out.dtype == torch.float32


@pytest.mark.parametrize("variant", [dict(family="rope", causal=True),
                                     dict(sparse="decoded"), dict()],
                         ids=["rope", "decoded", "tile"])
def test_pipeline_variants_run_plain_equal_fused(variant):
    """The pipelined variants, which raised before they were ported, run
    their plain version on CPU tensors (no launch), equal to the fused
    one in outputs and counts."""
    t, b, l, d, heads, hd, ff, l_block = SHAPES["odd"]
    if variant.get("family") == "rope":
        from test_torch_lm import rope_layer_ops
        targs = to_torch(rope_layer_ops(5, t, b, l, d, heads, hd, 22))
    else:
        targs = to_torch(layer_ops(5, t, b, l, d, heads, hd, ff))
    kw = dict(_kw(heads, hd), **variant)
    before = dict(TFL.LAUNCHES)
    got = TFL.fused_layer(*targs, l_block=l_block, pipeline=True, **kw)
    want = TFL.fused_layer(*targs, l_block=l_block, **kw)
    assert TFL.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(want[0].std()) > 0


@pytest.mark.parametrize("variant", [dict(causal=True, binarize_scores=False),
                                     dict(binarize_scores=False)])
def test_unported_variants_raise(variant):
    """The analog-score variants, which raised ``NotImplementedError``
    until they were ported, run their plain version on CPU tensors (no
    launch): finite, and another function than the binarized layer
    (``test_torch_analog.py`` holds them against JAX)."""
    t, b, l, d, heads, hd, ff, l_block = SHAPES["odd"]
    targs = to_torch(layer_ops(5, t, b, l, d, heads, hd, ff))
    kw = dict(_kw(heads, hd), **variant)
    before = dict(TFL.LAUNCHES)
    out, cnt = TFL.fused_layer(*targs, l_block=l_block, **kw)
    assert TFL.LAUNCHES == before
    assert torch.isfinite(out).all() and float(out.std()) > 0
    binarized = dict(kw, binarize_scores=True)
    assert not torch.equal(out, TFL.fused_layer(*targs, l_block=l_block,
                                                **binarized)[0])
    # every score block is live with analog scores
    assert (cnt[:, 3] == t * b).all()


@pytest.mark.parametrize("bad", ["wide_head", "d_off_grid", "half", "mixed"])
def test_kernel_launcher_rejects_operands_before_launching(bad):
    """The CUDA launcher checks shapes and dtypes before it builds or
    calls the kernel, so these raise here too, where there is no card
    (launch A takes head_dim up to 128: a row's q or k bits in four
    words, and D a multiple of 16; launch B takes any T)."""
    t, l = 2, 13
    heads, hd, ff = 2, 136 if bad == "wide_head" else 8, 16
    d = 24 if bad == "d_off_grid" else 16
    args, kw = TFL.prepare(*to_torch(layer_ops(7, t, 1, l, d, heads, hd, ff)),
                           num_heads=heads, head_dim=hd,
                           scale=1.0 / math.sqrt(hd), decay=0.5, v_th=1.0,
                           soft_reset=False, eps=1e-5, l_block=8)
    if bad == "half":
        args = (args[0].half(), args[1].half()) + args[2:]
    if bad == "mixed":
        args = args[:2] + (args[2].double(),) + args[3:]
    with pytest.raises(ValueError):
        TFL.fused_layer_cuda(*args, **kw)


def test_layer_at_8_512_width_bitwise_against_jitted_jax_oracle():
    """One layer of Spikingformer-8-512 at its published widths (T=4,
    B=1, L=196, D=512, 8 heads of 64, d_ff=2048) on dyadic weights: the
    plain version, tile and decoded with the engine's l_block (two
    L-blocks, the second ragged), bitwise equal to the jitted JAX
    ``reference_layer``; the same counts of executed L-blocks for the
    binary and post-attention phases."""
    t, b, l, d, heads, hd, ff = 4, 1, 196, 512, 8, 64, 2048
    args = layer_ops(17, t, b, l, d, heads, hd, ff)
    want = _jax_reference(args, t, heads, hd)
    assert np.isfinite(want).all() and want.std() > 0
    targs = to_torch(args)
    cnts = {}
    for sparse in ("tile", "decoded"):
        out, cnts[sparse] = TFL.fused_layer(*targs, l_block=128, sparse=sparse,
                                            **_kw(heads, hd))
        np.testing.assert_array_equal(out.numpy(), want, err_msg=sparse)
        assert cnts[sparse].shape == (heads, 8, 2)
    assert torch.equal(cnts["tile"][:, 3:], cnts["decoded"][:, 3:])
