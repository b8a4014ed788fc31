"""The port's quantization-aware training and PTQ calibration against the
JAX package (``repro.quant.qat``, ``repro.quant.calibrate``).

* ``fake_quant``: bitwise against JAX's for int8 and int4, on 2-D and
  scan-stacked 3-D weights, fp32 and bf16; its gradient is the identity
  (the straight-through estimator). JAX's is called eagerly, as JAX's
  ``quantize_tree`` runs when it loads a model to serve: under jit, XLA
  turns the scale's ``amax / qmax`` into ``amax * fl(1 / qmax)``, which
  is an ulp off on some channels (ROADMAP queue 3);
* ``fake_quant_tree`` == the port's ``dequantize_tree(quantize_tree(...))``
  == JAX's ``fake_quant_tree``, bitwise, and leaves every non-linear leaf
  alone;
* one QAT train step (int8, int4) of Spikingformer-4-256 SMOKE within
  ``test_torch_train.py``'s tolerances of jitted JAX ``build_train_step(
  cfg, opt, qat=...)``, on masters whose per-column amax is ``qmax *
  2^-e`` (so the fake-quantized weights are dyadic and the loss is held
  bitwise);
* ``logit_delta`` within 1e-6 relative of JAX's on the same arrays;
* ``calibrate`` on spikingformer-lm SMOKE and on Spikingformer-4-256 SMOKE
  (``tests/test_quant.py``'s setups) chooses JAX's clip ratio, every
  candidate's MAE and the reference's std within 1e-6 relative of JAX's
  (the forwards differ by an ulp: the rsqrt gap of ``test_torch_lm.py``),
  their quotient ``logit_mae_rel`` within the sum of the two, 2e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import quant as JQ  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import quant as TQ  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import registry as TMR  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from _torch_train_helpers import (FAMILY_ARCHS, check_train_step,  # noqa: E402
                                  family_batch)

QMAX = {"int8": 127, "int4": 7}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Hundreds of small CPU ops a test: with other test workers on the
    machine, torch's thread pool spins against them, so run on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.2, shape).astype(np.float32)
    w[..., 3, :] *= 4.0                     # an outlier row sets the scale
    w[..., :, 0] = 0.0                      # an all-zero column (scale eps)
    return np.asarray(jnp.asarray(w, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 40), (3, 33, 20)])
@pytest.mark.parametrize("qdtype", ["int8", "int4"])
def test_fake_quant_bitwise_against_jax(qdtype, shape, dtype):
    w = _weights(sum(shape), shape, dtype)
    bits = JQ.quantize.INT_BITS[qdtype]
    want = np.asarray(JQ.fake_quant(w, bits))
    got = TQ.fake_quant(interop.to_torch(w, device="cpu"), bits)
    assert str(got.dtype).endswith(dtype)
    got = interop.to_numpy(got)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert not np.array_equal(np.asarray(w, np.float32),
                              np.asarray(want, np.float32))


@pytest.mark.parametrize("qdtype", ["int8", "int4"])
def test_fake_quant_gradient_is_the_identity(qdtype):
    w = torch.from_numpy(_weights(1, (3, 16, 8), "float32").copy()
                         ).requires_grad_()
    g = torch.randn((3, 16, 8), generator=torch.Generator().manual_seed(2))
    TQ.fake_quant(w, TQ.INT_BITS[qdtype]).backward(g)
    assert torch.equal(w.grad, g)


@pytest.mark.parametrize("qdtype", ["int8", "int4"])
def test_fake_quant_tree_against_quantize_tree_and_jax(qdtype):
    cfg = jget_config("spikingformer-4-256", smoke=True)
    params = jax.tree_util.tree_map(np.asarray,
                                    JR.init(cfg, jax.random.PRNGKey(3)))
    want = JQ.fake_quant_tree(params, qdtype)
    tp = interop.to_torch(params, device="cpu")
    got = TQ.fake_quant_tree(tp, qdtype)
    served = TQ.dequantize_tree(TQ.quantize_tree(tp, qdtype))
    jl, jdef = jax.tree_util.tree_flatten(want)
    for other in (got, served):
        tl, tdef = jax.tree_util.tree_flatten(interop.to_numpy(other))
        assert tdef == jdef
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(b, np.asarray(a))
    # convs, norms, biases and the attention threshold pass through
    assert got["sps"][0]["conv"]["w"] is tp["sps"][0]["conv"]["w"]
    assert got["blocks"]["bn_q"]["scale"] is tp["blocks"]["bn_q"]["scale"]
    assert got["head"]["b"] is tp["head"]["b"]
    assert not torch.equal(got["blocks"]["wq"]["w"], tp["blocks"]["wq"]["w"])


def _vision_linears(params):
    return [params["blocks"][name] for name in
            ("wq", "wk", "wv", "wo", "w1", "w2")] + [params["head"]]


def qat_masters(params, qdtype, seed, linears=_vision_linears):
    """Dyadic params whose linear weights have, in every column, an amax
    of ``qmax * 2^-e`` (e per leaf, near the leaf's own amax): the
    per-column scale is then ``2^-e`` exactly, the fake-quantized weights
    are dyadic, and every product of the forward is an exact fp32 sum.
    ``linears(params)`` lists the linear dicts to fix (the vision
    tree's by default)."""
    rng = np.random.default_rng(seed)
    qmax = QMAX[qdtype]
    out = jax.tree_util.tree_map(lambda a: a, params)

    def fix(node):
        w = node["w"]
        k, n = w.shape[-2:]
        e = int(np.floor(np.log2(qmax / np.abs(w).max())))
        amax = qmax * 2.0 ** -e
        w = np.clip(w, -amax, amax)
        cols = np.arange(n)
        w[..., rng.integers(0, k, n), cols] = np.where(
            rng.random(n) < 0.5, -amax, amax)
        node["w"] = w.astype(np.float32)

    for node in linears(out):
        fix(node)
    return out


@pytest.mark.parametrize("qdtype", ["int8", "int4"])
def test_qat_train_step_against_the_jitted_jax_step(qdtype):
    from test_torch_train import _train_setup
    cfg, tcfg, params, state, batch = _train_setup(seed=4)
    cfg = cfg.replace(engine=jget_config("spikingformer-4-256",
                                         smoke=True).engine)
    tcfg = tcfg.replace(engine=get_config("spikingformer-4-256",
                                          smoke=True).engine)
    masters = qat_masters(params, qdtype, seed=5)
    fq = jax.tree_util.tree_map(np.asarray,
                                JQ.fake_quant_tree(masters, qdtype))
    for name in ("wq", "w1", "w2"):
        w = fq["blocks"][name]["w"]
        assert np.array_equal(w * 2 ** 12, np.round(w * 2 ** 12))
    loss = check_train_step(cfg, tcfg, masters, state, batch, qat=qdtype)
    # QAT is not the fp step: the loss sees the rounded weights
    tp = interop.to_torch(masters, device="cpu")
    ts = interop.to_torch(state, device="cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    fp_loss = float(TS.value_and_grad(tcfg, tp, tb, ts)[0])
    assert loss != fp_loss


@pytest.mark.parametrize("family", ["moe", "rwkv", "hybrid", "encdec",
                                    "vlm"])
def test_qat_refused_outside_the_stateful_family(family):
    """The LM's QAT, refused here before it was ported, takes a step, and
    so does a sliding-window LM's and the case's family's (an MoE, rwkv,
    hybrid, encdec or vlm SMOKE model), refused before their slices; a
    server refuses a mesh that is no ``launch.mesh.Mesh``, and an unknown
    qat dtype is refused."""
    lm = get_config("spikingformer-lm", smoke=True)
    opt = adamw(1e-3)
    tp = interop.to_torch(jax.tree_util.tree_map(
        np.asarray, JR.init(jget_config("spikingformer-lm", smoke=True),
                            jax.random.PRNGKey(0))), device="cpu")
    tokens = {"tokens": np.arange(10, dtype=np.int32).reshape(2, 5)}
    _, _, nstep, m = TS.build_train_step(lm, opt, qat="int8", device="cpu")(
        tp, opt.init(tp), 0, tokens)
    assert nstep == 1 and np.isfinite(float(m["loss"]))
    swa = TS.build_train_step(lm.replace(attn_type="swa", window=3), opt,
                              qat="int8", device="cpu")
    _, _, nstep, m = swa(tp, opt.init(tp), 0, tokens)
    assert nstep == 1 and np.isfinite(float(m["loss"]))
    other = get_config(FAMILY_ARCHS[family], smoke=True)
    mp = TMR.init(other, 0, device="cpu")
    _, _, nstep, m = TS.build_train_step(other, opt, qat="int8",
                                         device="cpu")(
        mp, opt.init(mp), 0, family_batch(other, 2, 5))
    assert nstep == 1 and np.isfinite(float(m["loss"]))
    if family == "moe":
        assert float(m["moe_aux"]) > 0
    from repro_torch.launch.serve import BatchedServer
    with pytest.raises(TypeError, match="Mesh"):
        BatchedServer(lm, tp, 2, 16, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="int2"):
        TS.build_train_step(get_config("spikingformer-4-256", smoke=True),
                            adamw(1e-3), qat="int2", device="cpu")


def test_logit_delta_against_jax():
    rng = np.random.default_rng(6)
    ref = rng.normal(0, 3, (8, 16, 40)).astype(np.float32)
    out = ref + rng.normal(0, 0.5, ref.shape).astype(np.float32)
    out[0, 0] = ref[0, 0]
    want = JQ.logit_delta(jnp.asarray(ref), jnp.asarray(out))
    got = TQ.logit_delta(torch.from_numpy(ref), torch.from_numpy(out))
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6, abs=0), key


def _check_report(got, want):
    assert got["dtype"] == want["dtype"]
    assert got["chosen"]["clip_ratio"] == want["chosen"]["clip_ratio"]
    assert len(got["candidates"]) == len(want["candidates"])
    for g, w in zip(got["candidates"], want["candidates"]):
        assert g["clip_ratio"] == w["clip_ratio"]
        for key, rel in (("logit_mae", 1e-6), ("ref_std", 1e-6),
                         ("logit_mae_rel", 2e-6)):
            assert g[key] == pytest.approx(w[key], rel=rel, abs=0), key
        assert g["argmax_agree"] == w["argmax_agree"]


@pytest.mark.parametrize("qdtype", ["int8", "int4"])
def test_calibrate_lm_chooses_jaxs_ratio(qdtype):
    """``tests/test_quant.py``'s LM setup: JAX-seeded SMOKE params, 4 x 16
    tokens."""
    cfg = jget_config("spikingformer-lm", smoke=True)
    params = JR.init(cfg, jax.random.PRNGKey(0))
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(2), (4, 16), 0,
                                          cfg.vocab_size)}
    _, want = JQ.calibrate(cfg, params, batch, qdtype)
    tree, got = TQ.calibrate(
        get_config("spikingformer-lm", smoke=True),
        interop.to_torch(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu"),
        {"tokens": torch.from_numpy(np.asarray(batch["tokens"]))}, qdtype)
    _check_report(got, want)
    assert TQ.is_quantized(tree["layers"]["wq"])


@pytest.mark.parametrize("qdtype", ["int8", "int4"])
def test_calibrate_vision_chooses_jaxs_ratio(qdtype):
    """``tests/test_quant.py``'s vision setup: JAX-seeded SMOKE params
    scaled by 3 so LIF neurons fire, 4 images of 2 * N(0, 1), the init
    BN state."""
    cfg = jget_config("spikingformer-4-256", smoke=True)
    params = jax.tree_util.tree_map(
        lambda a: a * 3.0 if a.ndim >= 2 else a,
        JR.init(cfg, jax.random.PRNGKey(0)))
    state = JR.init_state(cfg)
    batch = {"images": 2.0 * jax.random.normal(jax.random.PRNGKey(2),
                                               (4, 16, 16, 3))}
    _, want = JQ.calibrate(cfg, params, batch, qdtype, state=state)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    _, got = TQ.calibrate(
        get_config("spikingformer-4-256", smoke=True),
        interop.to_torch(np_tree(params), device="cpu"),
        {"images": torch.from_numpy(np.asarray(batch["images"]))}, qdtype,
        state=interop.to_torch(np_tree(state), device="cpu"))
    _check_report(got, want)
