"""The port's int8 / int4 weight datapath (``repro_torch.quant`` and the
engine's quantized dispatch) against the JAX package.

* ``quantize_weight`` / ``quantize_tree`` / ``pack_int4`` /
  ``unpack_int4`` / ``dequantize_tree`` / ``footprint_report`` equal JAX's
  bitwise (codes, scales, every leaf and every byte count), int8 and
  int4, dyadic and not, odd K and stacked layers;
* ``dense_quant_linear`` equals JAX's bitwise on dyadic activations (an
  exact sum in any order) and within 1e-6 relative on analog ones;
* the engine's weights declaration, the quantized ``nn.linear`` /
  ``spike_linear`` dispatch (dense: the quantized reference; sparse: the
  unported int8 kernels raise), and the all-quantized vision layer
  (Spikingformer-4-256 SMOKE, int8, dyadic scales) against JAX.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.quant import quantize as JQ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.quant import quantize as Q  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _np_leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _jax_params(arch):
    cfg = jget_config(arch, smoke=True)
    return cfg, jax.tree_util.tree_map(
        np.asarray, jregistry.init(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("shape", [(64, 48), (33, 16), (3, 40, 24)])
def test_quantize_weight_matches_jax_bitwise(shape, dtype, dyadic):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) / 8).astype(np.float32)
    w[..., 0, 1] = 0.0                       # a zero in a channel
    w[..., :, 2] = 0.0                       # an all-zero channel (eps)
    want = JQ.quantize_weight(jnp.asarray(w), dtype, dyadic=dyadic)
    got = Q.quantize_weight(torch.from_numpy(w), dtype, dyadic=dyadic)
    assert got["qw"].dtype == (torch.uint8 if dtype == "int4"
                               and shape[-2] % 2 == 0 else torch.int8)
    np.testing.assert_array_equal(got["qw"].numpy(), np.asarray(want["qw"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        Q.dequantize_weight(got, shape[-2]).numpy(),
        np.asarray(JQ.dequantize_weight(want, shape[-2])))
    assert Q.weight_bits(got) == JQ.weight_bits(want)


@pytest.mark.parametrize("k", [7, 8, 31])
def test_pack_int4_roundtrip_matches_jax(k):
    rng = np.random.default_rng(k)
    q = rng.integers(-8, 8, (2, k, 5)).astype(np.int8)
    want = np.asarray(JQ.pack_int4(jnp.asarray(q)))
    got = Q.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(Q.unpack_int4(got, k).numpy(), q)
    np.testing.assert_array_equal(
        Q.unpack_int4(got, k).numpy(),
        np.asarray(JQ.unpack_int4(jnp.asarray(want), k)))


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("arch", ["spikingformer-lm", "spikingformer-4-256"])
def test_quantize_tree_and_footprint_match_jax(arch, dtype):
    _, jp = _jax_params(arch)
    tp = interop.to_torch(jp, device="cpu")
    want = JQ.quantize_tree(jp, dtype)
    got = Q.quantize_tree(tp, dtype)
    wl, gl = _np_leaves(want), [a.numpy() for a in tree_leaves(
        _sorted(got))]
    assert len(wl) == len(gl)
    for a, b in zip(wl, gl):
        assert a.dtype == b.dtype or (a.dtype.name == "bfloat16")
        np.testing.assert_array_equal(b.view(a.dtype) if a.dtype.name ==
                                      "bfloat16" else b, a)
    assert Q.footprint_report(tp, got) == JQ.footprint_report(jp, want)
    back = Q.dequantize_tree(got)
    wback = JQ.dequantize_tree(want)
    for a, b in zip(_np_leaves(wback), tree_leaves(_sorted(back))):
        np.testing.assert_array_equal(interop._leaf_to_numpy(b), a)
    with pytest.raises(ValueError):
        Q.quantize_tree(tp, "int2")


def _sorted(tree):
    """The tree with dict keys in JAX's flattening order (sorted)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("inputs", ["dyadic", "analog"])
def test_dense_quant_linear_matches_jax(inputs, dtype):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 64, 24)).astype(np.float32) / 8
    x = (rng.integers(-64, 64, (5, 64)) / 64.0 if inputs == "dyadic"
         else rng.standard_normal((5, 64))).astype(np.float32)
    jp = JQ.quantize_weight(jnp.asarray(w), dtype)
    jp = {"qw": jp["qw"][1], "scale": jp["scale"][1],
          "b": jnp.asarray(rng.standard_normal(24).astype(np.float32))}
    want = np.asarray(jax.jit(JE.dense_quant_linear)(jp, jnp.asarray(x)))
    tp = interop.to_torch(jax.tree_util.tree_map(np.asarray, jp),
                          device="cpu")
    got = E.dense_quant_linear(tp, torch.from_numpy(x)).numpy()
    if inputs == "dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # nn.linear on a quantized dict takes the same reference on analog
    # inputs, with or without an engine
    np.testing.assert_array_equal(nn.linear(tp, torch.from_numpy(x)).numpy(),
                                  got)


def test_engine_weights_declaration_and_quantized_dispatch():
    with pytest.raises(ValueError, match="weights datapath"):
        E.EngineConfig(weights="int2")
    w = torch.randn(32, 8)
    qp = Q.quantize_weight(w, "int8")
    q4 = Q.quantize_weight(w, "int4")
    s = (torch.rand(3, 32) < 0.5).float()
    int8 = E.EngineConfig(mode="dense", weights="int8")
    # a declared int8 datapath must be handed int8 codes
    with pytest.raises(ValueError, match="unquantized"):
        E.spike_linear({"w": w}, s, engine=int8)
    with pytest.raises(ValueError, match="packed int4"):
        E.spike_linear(q4, s, engine=int8)
    # int4 accepts int8-stored codes (the odd-K rule) and packed nibbles
    for p in (qp, q4):
        out = E.spike_linear(p, s, engine=int8.replace(weights="int4"))
        np.testing.assert_array_equal(out.numpy(),
                                      E.dense_quant_linear(p, s).numpy())
    # dense mode takes the quantized reference; the sparse path runs the
    # int8 kernels' plain versions on CPU tensors, with the same sums and
    # epilogue (tile and decoded)
    with E.use_engine(int8):
        np.testing.assert_array_equal(
            nn.linear(qp, s, spikes=True).numpy(),
            E.dense_quant_linear(qp, s).numpy())
    for path in ("tile", "decoded"):
        np.testing.assert_array_equal(
            E.spike_linear(qp, s, engine=int8.replace(
                mode="sparse", sparse=path)).numpy(),
            E.dense_quant_linear(qp, s).numpy())


@pytest.mark.parametrize("overlap", ["off", "fused"])
def test_int8_vision_forward_matches_jax(overlap):
    """The all-quantized vision layer: its codes cast into the layer
    program (no new kernel). On the dyadic setup of the vision forward
    test with dyadic scales every sum is exact, so the logits agree
    bitwise; the JAX forward runs the oracle ('off')."""
    from test_torch_spikingformer import _setup
    jcfg, cfg, params, state, batch = _setup("spikingformer-4-256")
    jq = jax.tree_util.tree_map(np.asarray,
                                JQ.quantize_tree(params, "int8", dyadic=True))
    jeng = jcfg.engine.replace(overlap="off", weights="int8")
    with JE.use_engine(jeng):
        want = np.asarray(jax.jit(lambda p, b, s: jregistry.forward(
            p, jcfg, b, state=s)[0])(jq, batch, state))
    cfg = cfg.replace(engine=cfg.engine.replace(overlap=overlap,
                                                weights="int8"))
    with E.engine_scope(cfg), torch.inference_mode():
        got, aux = registry.forward(interop.to_torch(jq, device="cpu"), cfg,
                                    interop.to_torch(batch, device="cpu"),
                                    state=interop.to_torch(state,
                                                           device="cpu"))
    assert np.isfinite(want).all() and want.std() > 0
    assert 0 < float(aux["fire_rate"]) < 1
    np.testing.assert_array_equal(got.numpy(), want)
