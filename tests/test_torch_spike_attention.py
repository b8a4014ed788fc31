"""``spike_attention`` (#7) at any head_dim, and the route of a layer that
launch A does not take.

* ``spike_attention_plain`` (what the wrapper runs on CPU tensors, and
  what the CUDA kernel is held to on the card) equals JAX
  ``spike_attention`` in interpret mode bitwise on binarized scores at
  head_dim 24 (no multiple of 16), 160 and 256 (past 128: the kernel's
  column slices), causal or not, at an L that is no multiple of 16 or
  64, fp32 and bf16; analog scores agree within ``L d scale 2^-23`` (XLA sums in its
  own order);
* ``fused_layer.launch_a_takes`` is True at every shipped spiking
  config's widths and False at head_dim 160 and at a bn D past the w3
  column slice's limit;
* an eval layer at head_dim 160 takes the sequential composition on the
  CPU under every overlap (no layer program, no bundle kernel; its
  binary attention is the ``spike_attention`` wrapper under
  ``binary='mxu_kernel'``): ``layer_step`` equals the jitted JAX
  ``layer_step`` bitwise on dyadic weights, ``layer_step_causal`` equals
  jitted JAX within the rope family's rmsnorm tolerance;
* the CUDA launcher still refuses mixed dtypes and non-contiguous
  operands before any build.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.kernels import spike_attention as JA  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.kernels import fused_layer as TFL  # noqa: E402
from repro_torch.kernels import fused_ssa as TFS  # noqa: E402
from repro_torch.kernels import spike_attention as TA  # noqa: E402

from _torch_helpers import agreeing_variances, dyadic  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
L_ODD = 37            # no multiple of 16 or 64
BLOCK = 16            # the interpret-mode kernel's blocks: a ragged last one


def _spikes(rng, shape, density):
    return (rng.random(shape) < density).astype(np.float32)


def _operands(seed, bh, l, d):
    rng = np.random.default_rng(seed)
    q, k, v = (_spikes(rng, (bh, l, d), p) for p in (0.3, 0.3, 0.5))
    k[0, :5] = 0.0                       # dark keys
    return q, k, v


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [24, 160, 256])
def test_plain_bitwise_against_jax_kernel_at_any_head_dim(d, causal, dtype):
    jd, td = DTYPES[dtype]
    q, k, v = _operands(d + causal, 2, L_ODD, d)
    scale = 1.0 / math.sqrt(d)
    # a delta between the counts' levels: about a third of the scores pass
    delta = 0.25 * d * scale * 0.3
    want = np.asarray(JA.spike_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)), scale=scale, delta=delta,
        causal=causal, block_q=BLOCK, block_k=BLOCK).astype(jnp.float32))
    got = TA.spike_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                             scale=scale, delta=delta, causal=causal)
    assert got.dtype == td and got.shape == (2, L_ODD, d)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert want.std() > 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [24, 160, 256])
def test_plain_analog_within_tolerance_at_any_head_dim(d, causal):
    """binarize_scores=False: up to L analog scores count * scale summed in
    ascending key order (XLA: its own order), so entries agree within
    L d scale 2^-23, not bitwise."""
    q, k, v = _operands(3 * d + causal, 2, L_ODD, d)
    scale = 1.0 / math.sqrt(d)
    want = np.asarray(JA.spike_attention(
        *(jnp.asarray(a) for a in (q, k, v)), scale=scale, delta=0.0,
        causal=causal, binarize_scores=False, block_q=BLOCK, block_k=BLOCK))
    got = TA.spike_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             scale=scale, delta=0.0, causal=causal,
                             binarize_scores=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=L_ODD * d * scale * 2.0 ** -23)
    assert np.abs(want).max() > 1.0


# --- the route of a layer that launch A does not take ----------------------

SPIKING = ("spikingformer-4-256", "spikingformer-8-512", "spikingformer-lm")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", SPIKING)
def test_launch_a_takes_every_shipped_spiking_config(arch, smoke):
    cfg = get_config(arch, smoke=smoke)
    for elem_size in (2, 4):
        assert TFL.launch_a_takes(elem_size, cfg.d_model, cfg.num_heads,
                                  cfg.head_dim, rope=cfg.family == "dense")


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("elem_size", [2, 4])
def test_launch_a_refuses_what_check_launch_shapes_refuses(elem_size, rope):
    """head_dim 160, and a bn D past the widest w3 column slice that fits
    a block beside its slab ring (3712 today; a rope block holds more)."""
    bounds = [(256, 8, 160), (256, 8, 136), (64, 2, 160)]
    d_max = 5504 if rope else 3712
    bounds.append((d_max + 16, 8, 32))
    for d, heads, hd in bounds:
        assert not TFL.launch_a_takes(elem_size, d, heads, hd, rope=rope)
        with pytest.raises(ValueError):
            TFL.check_launch_shapes(elem_size, 4, 64, d, heads, hd, 1,
                                    rope=rope)
    assert TFL.launch_a_takes(elem_size, d_max, 8, 32, rope=rope)
    TFL.check_launch_shapes(elem_size, 4, 64, d_max, 8, 32, 1, rope=rope)


HD160 = dict(num_heads=2, num_kv_heads=2, head_dim=160)


def _layer_setup(arch, seed):
    """(JAX cfg, port cfg, layer 0's numpy params and BN state) at SMOKE
    depth with 2 heads of 160: dyadic weights, BN affines and means,
    variances on which XLA's and torch's rsqrt agree."""
    cfg = jget_config(arch, smoke=True).replace(**HD160)
    tcfg = get_config(arch, smoke=True).replace(**HD160)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.round(a * 256) / 256),
        JR.init(cfg, jax.random.PRNGKey(seed)))
    vision = cfg.family == "spikingformer"
    layer = jax.tree_util.tree_map(lambda a: a[0],
                                   params["blocks" if vision else "layers"])
    state = None
    if vision:
        for name, bn in layer.items():
            if name.startswith("bn_"):
                bn["scale"] = (1.0 + dyadic(rng, bn["scale"].shape) * 0.5
                               ).astype(np.float32)
                bn["bias"] = (0.25 + dyadic(rng, bn["bias"].shape) * 0.5
                              ).astype(np.float32)
        state = jax.tree_util.tree_map(
            lambda a: np.asarray(a[0]), JR.init_state(cfg)["blocks"])
        for st in state.values():
            st["mean"] = dyadic(rng, st["mean"].shape) * 0.25
            st["var"] = agreeing_variances(rng, st["var"].size)
    return cfg, tcfg, layer, state


def _route_spies(monkeypatch):
    """Counts the layer program's and the bundle kernel's calls, and the
    head dims the spike_attention wrapper sees."""
    seen = {"layer": 0, "bundle": 0, "attention": []}
    real_attn = TA.spike_attention

    def attention(q, *a, **kw):
        seen["attention"].append(q.shape[-1])
        return real_attn(q, *a, **kw)

    def never(what):
        def fn(*a, **kw):
            seen[what] += 1
            raise AssertionError(f"{what} kernel reached")
        return fn

    monkeypatch.setattr("repro_torch.kernels.ops.spike_attention", attention)
    monkeypatch.setattr(TFL, "fused_layer", never("layer"))
    monkeypatch.setattr(TFL, "reference_layer", never("layer"))
    monkeypatch.setattr(TFS, "fused_ssa", never("bundle"))
    return seen


def test_layer_step_at_head_dim_160_takes_the_sequential_composition(
        monkeypatch):
    cfg, tcfg, layer, state = _layer_setup("spikingformer-4-256", 0)
    t = cfg.spiking.time_steps
    x = (np.random.default_rng(1).integers(-64, 224, (t, 2, 16, cfg.d_model))
         / 128.0).astype(np.float32)
    with JE.use_engine(cfg.engine.replace(overlap="off")):
        want = np.asarray(jax.jit(
            lambda p, s, u: JE.layer_step(p, s, cfg, u)[0])(layer, state, x))
    assert np.isfinite(want).all() and want.std() > 0
    tp, ts = (interop.to_torch(a, device="cpu") for a in (layer, state))
    assert not TFL.launch_a_takes(4, cfg.d_model, 2, 160)
    seen = _route_spies(monkeypatch)
    for overlap in ("off", "fused", "pipeline"):
        engine = tcfg.engine.replace(overlap=overlap, mode="sparse",
                                     binary="mxu_kernel")
        with TE.use_engine(engine):
            y, new_st = TE.layer_step(tp, ts, tcfg, torch.from_numpy(x))
        np.testing.assert_array_equal(y.numpy(), want, err_msg=overlap)
        assert set(new_st) == set(ts)
    assert seen == {"layer": 0, "bundle": 0, "attention": [160] * 3}


def test_layer_step_causal_at_head_dim_160_takes_the_sequential_composition(
        monkeypatch):
    """Within 1e-5: the rmsnorms' rsqrt rounds apart in XLA and torch
    (ROADMAP queue 3), as the other rope-family comparisons with JAX."""
    cfg, tcfg, layer, _ = _layer_setup("spikingformer-lm", 2)
    t = cfg.spiking.time_steps
    x = (np.random.default_rng(3).standard_normal((t, 2, 12, cfg.d_model))
         * 0.5).astype(np.float32)
    pos = np.arange(12)
    with JE.use_engine(cfg.engine.replace(overlap="off")):
        want = np.asarray(jax.jit(
            lambda p, u: JE.layer_step_causal(p, cfg, u, pos))(layer, x))
    assert np.isfinite(want).all() and want.std() > 0
    tp = interop.to_torch(layer, device="cpu")
    seen = _route_spies(monkeypatch)
    for overlap in ("off", "fused"):
        engine = tcfg.engine.replace(overlap=overlap, mode="sparse",
                                     binary="mxu_kernel")
        with TE.use_engine(engine):
            y = TE.layer_step_causal(tp, tcfg, torch.from_numpy(x),
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=overlap)
    assert seen == {"layer": 0, "bundle": 0, "attention": [160] * 2}


def test_cuda_launcher_refuses_mixed_dtypes_and_strided_operands():
    """Before any build or launch: #7 takes any d now, so what it still
    refuses is operands it cannot read as one dtype's dense rows."""
    q = torch.zeros((1, 8, 200))
    with pytest.raises(ValueError, match="one dtype"):
        TA.spike_attention_cuda(q, q.bfloat16(), q, scale=1.0, delta=0.0)
    with pytest.raises(ValueError, match="one dtype"):
        TA.spike_attention_cuda(*(q.half(),) * 3, scale=1.0, delta=0.0)
    strided = torch.zeros((1, 200, 8)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        TA.spike_attention_cuda(strided, q, q, scale=1.0, delta=0.0)
    assert TA.LAUNCHES["spike_attention"] == 0
