"""The port's training slice against the JAX package.

* surrogate gradients against ``jax.grad``: ``spike``, ``binarize`` (to
  ``x`` and ``delta``), ``lif_scan`` through time, the sparse engine's
  product (``spike_linear`` under ``mode='sparse'``) and
  ``binary_attention`` (the kernel forward, the oracle backward);
* train-mode ``batchnorm``, one ``adamw`` update, ``warmup_cosine`` and
  the synthetic image batches;
* one whole ``build_train_step`` on Spikingformer-4-256 SMOKE with JAX's
  dyadic parameters, both packages forced onto the kernel modes
  (``mode='sparse', binary='mxu_kernel'``), against the jitted JAX train
  step: loss, metrics, new params, new BN state and, through
  ``steps.value_and_grad``, every gradient, with the flipped spikes of
  each layer counted;
* the training loop, the dispatch rules and the paths still unported.
"""
import dataclasses
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import spiking as JSp  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import make_pipeline as jmake_pipeline  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import nn as JN  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import spikingformer as JSF  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from _torch_train_helpers import FAMILY_ARCHS, family_batch  # noqa: E402
from repro_torch.core import attention as TAt  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import spiking as TSp  # noqa: E402
from repro_torch.data import DataConfig, make_pipeline  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import nn as TN  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import spikingformer as TSF  # noqa: E402
from repro_torch.optim import adamw, warmup_cosine  # noqa: E402

from _torch_helpers import dyadic  # noqa: E402

ARCH = "spikingformer-4-256"
KERNEL_MODES = dict(mode="sparse", binary="mxu_kernel")


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _rel_close(got, want, rel, what=""):
    """|got - want| <= rel * max|want| (a tolerance relative to the
    leaf's scale, as fp32 sums in another order differ by ulps of it)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


# --- surrogate gradients ---------------------------------------------------


def test_spike_and_binarize_surrogate_gradients_match_jax():
    """Forward bitwise; backward alpha * s * (1 - s) with s =
    sigmoid(alpha v): torch's and XLA's fp32 sigmoid differ by an ulp or
    two, so gradients agree to 1e-6 of their scale (delta's gradient is a
    sum over all entries)."""
    rng = np.random.default_rng(0)
    v = rng.normal(0, 1, (64, 16)).astype(np.float32)
    c = rng.normal(0, 1, (64, 16)).astype(np.float32)
    delta = np.float32(0.3)
    alpha = 4.0
    jv, jd = jax.jit(jax.grad(lambda v_, d_: (JSp.binarize(v_, d_, alpha)
                                             * c).sum(), argnums=(0, 1)))(
        v, delta)
    tv, td = _t(v, True), _t(delta, True)
    out = TSp.binarize(tv, td, alpha)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(JSp.binarize(v, delta, alpha)))
    (out * _t(c)).sum().backward()
    _rel_close(tv.grad.numpy(), jv, 1e-6, "dx")
    _rel_close(td.grad.numpy(), jd, 1e-6, "ddelta")
    gs = jax.grad(lambda v_: (JSp.spike(v_, alpha) * c).sum())(v)
    tv2 = _t(v, True)
    (TSp.spike(tv2, alpha) * _t(c)).sum().backward()
    _rel_close(tv2.grad.numpy(), gs, 1e-6, "spike")


@pytest.mark.parametrize("soft_reset", [False, True])
def test_lif_scan_gradient_through_time_matches_jax(soft_reset):
    """The reset is differentiated through the spike, as in JAX; four
    steps of surrogate products agree to 1e-5 of the gradient's scale."""
    rng = np.random.default_rng(1)
    x = rng.normal(0.6, 0.8, (4, 32, 8)).astype(np.float32)
    c = rng.normal(0, 1, (4, 32, 8)).astype(np.float32)
    cu = rng.normal(0, 1, (32, 8)).astype(np.float32)
    jcfg = JSp.SpikingConfig(time_steps=4, soft_reset=soft_reset)
    tcfg = TSp.SpikingConfig(time_steps=4, soft_reset=soft_reset)

    def jloss(x_):
        s, u = JSp.lif_scan(x_, jcfg)
        return (s * c).sum() + (u * cu).sum()
    want = jax.jit(jax.grad(jloss))(x)
    tx = _t(x, True)
    s, u = TSp.lif_scan(tx, tcfg)
    ((s * _t(c)).sum() + (u * _t(cu)).sum()).backward()
    _rel_close(tx.grad.numpy(), want, 1e-5, "dx")
    assert np.abs(np.asarray(want)).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_matmul_gradients_match_jax_bitwise(dtype):
    """spike_linear under mode='sparse': the kernel forward and the
    dense-transpose backward (ds cast to the spike dtype, dw to the weight
    dtype). Dyadic weights and cotangents make every sum exact, so the
    forward and both gradients are bitwise."""
    rng = np.random.default_rng(2)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    s = (rng.random((2, 3, 10, 40)) < 0.3).astype(np.float32)
    s[0] = 0.0
    w = dyadic(rng, (40, 24))
    c = dyadic(rng, (2, 3, 10, 24))
    eng = JE.EngineConfig(mode="sparse", sparse="tile", block_m=16,
                          block_n=16, block_k=16)

    def jloss(s_, w_):
        y = JE.spike_linear({"w": w_}, s_, engine=eng)
        return (y.astype(jnp.float32) * c).sum(), y
    (_, jy), (jds, jdw) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(s, jd),
                                              jnp.asarray(w, jd))
    ts = _t(s).to(td).requires_grad_()
    tw = _t(w).to(td).requires_grad_()
    ty = TE.spike_linear({"w": tw}, ts,
                         engine=TE.EngineConfig(mode="sparse"))
    (ty.float() * _t(c)).sum().backward()
    assert ty.dtype == td and ts.grad.dtype == td and tw.grad.dtype == td
    for got, want in ((ty, jy), (ts.grad, jds), (tw.grad, jdw)):
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("causal", [False, True])
def test_binary_attention_gradients_match_jax(causal):
    """Kernel forward (bitwise), surrogate recompute backward to q, k, v
    and delta: sigmoid ulps and summation order keep the gradients within
    1e-5 of their scale."""
    rng = np.random.default_rng(3)
    bh, l, d = 4, 13, 16
    q, k, v = ((rng.random((bh, l, d)) < 0.4).astype(np.float32)
               for _ in range(3))
    c = rng.normal(0, 1, (bh, l, d)).astype(np.float32)
    delta = np.float32(0.3)
    scale = 1.0 / math.sqrt(d)

    def jloss(q_, k_, v_, d_):
        out = JO.binary_attention(q_, k_, v_, scale=scale, delta=d_,
                                  causal=causal, block_q=8, block_k=8)
        return (out * c).sum(), out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(q, k, v, delta)
    leaves = [_t(a, True) for a in (q, k, v, delta)]
    out = TO.binary_attention(*leaves[:3], scale=scale, delta=leaves[3],
                              causal=causal)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    (out * _t(c)).sum().backward()
    for name, t, want in zip("qkvΔ", leaves, jgrads):
        _rel_close(t.grad.numpy(), want, 1e-5, f"d{name}")
    assert np.abs(np.asarray(jgrads[0])).max() > 0


# --- BN, optimizer, schedule, data -----------------------------------------


def test_train_mode_batchnorm_matches_jax():
    """Batch mean and population variance are summed in another order
    than XLA's, and rsqrt differs by an ulp or two (ROADMAP queue 3): the
    output agrees to 1e-5 of its scale, the running stats to 1e-6."""
    rng = np.random.default_rng(4)
    x = rng.normal(0.3, 1.5, (6, 5, 12)).astype(np.float32)
    p = {"scale": 1.0 + dyadic(rng, 12) * 0.5, "bias": dyadic(rng, 12)}
    st = {"mean": dyadic(rng, 12) * 0.25,
          "var": rng.uniform(0.5, 2.0, 12).astype(np.float32)}
    jy, jst = jax.jit(lambda x_: JN.batchnorm(p, st, x_, train=True))(x)
    tx = _t(x, True)
    ty, tst = TN.batchnorm({k: _t(v) for k, v in p.items()},
                           {k: _t(v) for k, v in st.items()}, tx,
                           train=True)
    _rel_close(ty.detach().numpy(), jy, 1e-5, "y")
    for key in ("mean", "var"):
        assert not tst[key].requires_grad
        _rel_close(tst[key].numpy(), jst[key], 1e-6, key)
    # the gradient flows through the batch statistics
    jg = jax.grad(lambda x_: (JN.batchnorm(p, st, x_, train=True)[0] ** 3
                              ).sum())(x)
    (ty ** 3).sum().backward()
    _rel_close(tx.grad.numpy(), jg, 1e-4, "dx")


def test_adamw_update_and_warmup_cosine_match_jax():
    """One AdamW update at step 3 on fp32 and bf16 leaves: fp32 leaves
    agree to 1e-6 of their scale (pow, sqrt and division round alike, the
    moment updates may contract differently), bf16 leaves to one bf16
    ulp; the schedule to 1e-6 relative."""
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(0, 0.1, (16, 8)).astype(np.float32),
              "delta": np.float32(0.3),
              "bn": {"scale": np.ones(8, np.float32)}}
    grads = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 2.0, np.shape(a)).astype(np.float32), params)
    sched = (2e-3, 5, 40)
    jsched, tsched = jwarmup_cosine(*sched), warmup_cosine(*sched)
    for step in range(0, 41, 3):
        _rel_close(tsched(step).numpy(),
                   jsched(jnp.asarray(step, jnp.int32)), 1e-6, f"lr {step}")
    jopt, topt = jadamw(jsched), adamw(tsched)
    for dtype in ("float32", "bfloat16"):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), grads)
        tp, tg = (interop.to_torch(jax.tree_util.tree_map(np.asarray, t),
                                   device="cpu") for t in (jp, jg))
        state = jopt.init(jp)
        state["m"] = jax.tree_util.tree_map(lambda a: a + 0.01, state["m"])
        state["v"] = jax.tree_util.tree_map(lambda a: a + 0.02, state["v"])
        tstate = interop.to_torch(jax.tree_util.tree_map(np.asarray, state),
                                  device="cpu")
        jnew, jst = jax.jit(jopt.update)(jg, state, jp,
                                         jnp.asarray(3, jnp.int32))
        tnew, tst = topt.update(tg, tstate, tp, 3)
        _rel_close(tst["grad_norm"].numpy(), jst["grad_norm"], 1e-6, "norm")
        for j, t in zip(jax.tree_util.tree_leaves(jnew),
                        jax.tree_util.tree_leaves(interop.to_numpy(tnew))):
            j32 = np.asarray(j, np.float32)
            t32 = np.asarray(t, np.float32)
            if dtype == "float32":
                _rel_close(t32, j32, 1e-6, "param")
            else:
                ulp = np.abs(np.spacing(j32.astype(np.float32))) * 2 ** 16
                assert (np.abs(t32 - j32) <= ulp).all()
        for key in ("m", "v"):
            for j, t in zip(jax.tree_util.tree_leaves(jst[key]),
                            jax.tree_util.tree_leaves(
                                interop.to_numpy(tst[key]))):
                _rel_close(t, j, 1e-6, key)


def test_synthetic_images_equal_the_jax_packages_bitwise():
    for batch, size in ((8, 16), (3, 32)):
        want = jmake_pipeline(JDataConfig(kind="images", global_batch=batch,
                                          img_size=size))
        got = make_pipeline(DataConfig(kind="images", global_batch=batch,
                                       img_size=size))
        for step in (0, 5):
            a, b = want.batch_at(step), got.batch_at(step)
            for key in ("images", "labels"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


# --- the whole train step --------------------------------------------------


def _train_setup(seed=0, batch=8, spiking=None, **engine):
    """JAX and port SMOKE configs on the kernel modes (and the ``engine``
    fields given; ``spiking``: SpikingConfig fields to replace), numpy
    dyadic params (BN affines drawn on the grid), init BN state and a
    batch of synthetic images rounded to k/256."""
    engine = {**KERNEL_MODES, **engine}
    spiking = spiking or {}
    cfg = jget_config(ARCH, smoke=True)
    cfg = cfg.replace(engine=cfg.engine.replace(**engine),
                      spiking=dataclasses.replace(cfg.spiking, **spiking))
    tcfg = get_config(ARCH, smoke=True)
    tcfg = tcfg.replace(engine=tcfg.engine.replace(**engine),
                        spiking=dataclasses.replace(tcfg.spiking, **spiking))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.round(a * 256) / 256),
        JR.init(cfg, jax.random.PRNGKey(seed)))
    for bn in [p["bn"] for p in params["sps"]] + [
            v for k, v in params["blocks"].items() if k.startswith("bn_")]:
        bn["scale"] = (1.0 + dyadic(rng, bn["scale"].shape) * 0.5
                       ).astype(bn["scale"].dtype)
        bn["bias"] = (0.25 + dyadic(rng, bn["bias"].shape) * 0.5
                      ).astype(bn["bias"].dtype)
    state = jax.tree_util.tree_map(np.asarray, JR.init_state(cfg))
    data = jmake_pipeline(JDataConfig(kind="images", global_batch=batch,
                                      img_size=cfg.vision.img_size))
    b = data.batch_at(0)
    b["images"] = (np.round(b["images"] * 256) / 256).astype(np.float32)
    return cfg, tcfg, params, state, b


def _flipped_spikes(cfg, tcfg, params, state, batch):
    """Per layer, given the same input currents (JAX's), the spikes of the
    layer's output that the two packages disagree on: the stem, then each
    encoder layer in train mode. Returns [(flipped, total), ...]."""
    images = jnp.asarray(batch["images"])
    x = jax.jit(lambda p, s: JSF._sps(p, s, cfg, images, True)[0])(
        params, state)
    tp = interop.to_torch(params, device="cpu")
    ts = interop.to_torch(state, device="cpu")
    tx = TSF._sps(tp, ts, tcfg, torch.from_numpy(np.array(images)),
                  True)[0]
    jlif = jax.jit(lambda u: JSp.lif_scan(u, cfg.spiking)[0])
    out = [(int((np.asarray(jlif(x)) != TSp.lif_scan(tx, tcfg.spiking)[0]
                 .numpy()).sum()), int(np.asarray(x).size))]
    jlayer = jax.jit(lambda p, s, u: JE.layer_step(p, s, cfg, u,
                                                   train=True)[0])
    for i in range(cfg.num_layers):
        bp = jax.tree_util.tree_map(lambda a: a[i], params["blocks"])
        bst = jax.tree_util.tree_map(lambda a: a[i], state["blocks"])
        with JE.use_engine(cfg.engine):
            y = jlayer(bp, bst, x)
        with TE.use_engine(tcfg.engine), torch.no_grad():
            ty = TE.layer_step(interop.to_torch(bp, device="cpu"),
                               interop.to_torch(bst, device="cpu"), tcfg,
                               torch.from_numpy(np.array(x)),
                               train=True)[0]
        out.append((int((np.asarray(jlif(y)) != TSp.lif_scan(
            ty, tcfg.spiking)[0].numpy()).sum()), int(np.asarray(y).size)))
        x = y
    return out


def test_train_step_against_the_jitted_jax_train_step():
    """Tolerances, each with its reason:
    * loss, fire rate: bitwise — no spike flips (counted per layer below);
    * gradients: 1e-4 of each leaf's scale — fp32 sums of up to ~1e5
      terms (BN statistics, dw, the delta gradient) in another order;
    * grad norm: 1e-6 relative; BN running stats: 1e-5 of each leaf's
      scale — the batch mean is a sum of T*B*H*W values with
      cancellation, so its rounding error scales with sum |x|, not with
      the mean;
    * params after the step: 5e-5 absolute — AdamW's first step is
      lr * g / (|g| + eps), which turns a gradient difference d into up
      to lr * d * eps / (|g| + eps)^2 for gradients near eps = 1e-8; a
      flipped gradient sign would move a param by 2 lr = 2e-3."""
    _check_train_step()


def test_decoded_train_step_against_the_jitted_jax_train_step():
    """sparse='decoded' on both sides: the six spike products of every
    layer run the decoded gather (the port's plain version, JAX's
    interpret-mode kernel under jit), with the tolerances above."""
    _check_train_step(sparse="decoded")


def _check_train_step(spiking=None, **engine):
    cfg, tcfg, params, state, batch = _train_setup(spiking=spiking, **engine)
    flips = _flipped_spikes(cfg, tcfg, params, state, batch)
    print("flipped spikes per layer (stem, blocks):", flips)
    assert sum(f for f, _ in flips) == 0, flips
    sched = (2e-3, 2, 10)
    jopt, topt = jadamw(jwarmup_cosine(*sched)), adamw(warmup_cosine(*sched))
    jp, jo, jstep, jm, jst = jax.jit(JS.build_train_step(cfg, jopt))(
        params, jopt.init(params), jnp.asarray(0, jnp.int32), batch, state)

    def jloss(p):
        with JE.engine_scope(cfg):
            logits, _ = JR.forward(p, cfg, batch, train=True, state=state)
        return JS.loss_from_forward(cfg, logits, batch)
    jgrads = jax.jit(jax.grad(jloss))(params)

    tp = interop.to_torch(params, device="cpu")
    ts = interop.to_torch(state, device="cpu")
    step = TS.build_train_step(tcfg, topt, device="cpu")
    np_, no, nstep, tm, nst = step(tp, topt.init(tp), 0, batch, ts)
    assert nstep == 1 and int(jstep) == 1
    assert float(tm["loss"]) == float(jm["loss"])
    assert float(tm["fire_rate"]) == float(jm["fire_rate"])
    _rel_close(tm["grad_norm"].numpy(), jm["grad_norm"], 1e-6, "grad_norm")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, tgrads = TS.value_and_grad(tcfg, tp, tb, ts)
    assert float(loss) == float(jm["loss"])
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    for what, want, got, check in (
            ("grad", jgrads, tgrads, lambda g, w, n: _rel_close(g, w, 1e-4,
                                                                n)),
            ("param", jp, np_, lambda g, w, n: np.testing.assert_allclose(
                g, w, rtol=0, atol=5e-5, err_msg=n)),
            ("state", jst, nst, lambda g, w, n: _rel_close(g, w, 1e-5, n))):
        jl = jax.tree_util.tree_leaves(want)
        tl = jax.tree_util.tree_leaves(interop.to_numpy(got))
        assert len(jl) == len(tl)
        names = paths if what != "state" else [""] * len(jl)
        for name, w, g in zip(names, jl, tl):
            assert np.shape(w) == np.shape(g)
            check(np.asarray(g, np.float64), np.asarray(w, np.float64),
                  what + name)
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(params),
        jax.tree_util.tree_leaves(interop.to_numpy(np_)))]
    assert all(moved)


@pytest.fixture
def one_torch_thread():
    """Hundreds of tiny CPU ops: with several test workers on the machine,
    torch's thread pool spins against the others (a 3 s loop took over
    3 minutes), so run them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_training_loop_lowers_the_loss_on_smoke(one_torch_thread):
    """40 steps at batch 16 on SMOKE from seed 0 (CPU): the mean loss of
    the last five steps is below that of the first five, as in the JAX
    package's loop at the same size."""
    losses = TT.train(ARCH, smoke=True, total_steps=40, batch=16, lr=3e-3,
                      seed=0, device="cpu")
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


# --- dispatch and what is still unported -----------------------------------


def _on(kind):
    return types.SimpleNamespace(device=torch.device(kind))


def test_dispatch_rules_for_the_spike_kernels():
    """'auto' picks the kernels for every CUDA tensor and the plain paths
    on the CPU; explicit modes are honoured everywhere."""
    auto = TE.EngineConfig()
    assert (auto.mode, auto.binary) == ("auto", "auto")
    assert TE.resolve_mode(auto, _on("cuda")) == "sparse"
    assert TE.resolve_binary_mode(auto, _on("cuda")) == "mxu_kernel"
    assert TE.resolve_mode(auto, _on("cpu")) == "dense"
    assert TE.resolve_binary_mode(auto, _on("cpu")) == "jnp"
    assert TE.resolve_mode(None, _on("cuda")) == "dense"
    assert TE.resolve_binary_mode(None, _on("cuda")) == "jnp"
    for dev in ("cpu", "cuda"):
        for m in ("dense", "sparse"):
            assert TE.resolve_mode(TE.EngineConfig(mode=m), _on(dev)) == m
        for b in ("jnp", "mxu_kernel", "popcount"):
            assert TE.resolve_binary_mode(TE.EngineConfig(binary=b),
                                          _on(dev)) == b
    for bad in (dict(mode="x"), dict(binary="x")):
        with pytest.raises(ValueError):
            TE.EngineConfig(**bad)


def test_kernel_modes_equal_plain_modes_on_the_cpu():
    """On CPU tensors the forced kernel modes run the kernels' plain
    versions; the forward equals the dense / oracle modes bitwise."""
    _, tcfg, params, state, batch = _train_setup(seed=1, batch=2)
    tp = interop.to_torch(params, device="cpu")
    ts = interop.to_torch(state, device="cpu")
    tb = interop.to_torch(batch, device="cpu")
    res = {}
    for modes in (KERNEL_MODES, dict(mode="dense", binary="jnp")):
        with TE.use_engine(tcfg.engine.replace(**modes)), torch.no_grad():
            res[modes["mode"]] = TR.forward(tp, tcfg, tb, train=True,
                                            state=ts)[0]
    np.testing.assert_array_equal(res["sparse"].numpy(),
                                  res["dense"].numpy())


@pytest.mark.parametrize("family", ["moe", "rwkv", "hybrid", "encdec",
                                    "vlm"])
def test_unported_training_modes_raise_naming_roadmap(family):
    tcfg = get_config(ARCH, smoke=True)
    opt = adamw(1e-3)
    s = torch.zeros((2, 1, 4, 8))
    p = {"w": torch.zeros((8, 4))}
    lm = get_config("spikingformer-lm", smoke=True)
    # gradient compression (which the vision step does not read, as in
    # JAX), the LM's QAT and its token stream, refused here before they
    # were ported, now build
    assert callable(TS.build_train_step(tcfg, opt, compress=True,
                                        device="cpu"))
    assert callable(TS.build_train_step(lm, opt, qat="int8", device="cpu"))
    data = make_pipeline(DataConfig(kind="lm", global_batch=2, seq_len=4,
                                    vocab_size=lm.vocab_size))
    tokens = data.batch_at(0)
    assert tokens["tokens"].shape == (2, 4)
    # training a sliding-window LM and a non-spiking dense model, which
    # raised here before they were ported, takes a step, and so does
    # training the case's family (MoE, rwkv, hybrid, encdec, vlm); the
    # server refuses a mesh that is no launch.mesh.Mesh
    for now in (lm.replace(attn_type="swa", window=3),
                lm.replace(spiking=None)):
        now_params = TR.init(now, 0, device="cpu")
        _, _, nstep, m = TS.build_train_step(now, opt, device="cpu")(
            now_params, opt.init(now_params), 0, tokens)
        assert nstep == 1 and np.isfinite(float(m["loss"]))
    lm_params = TR.init(lm, 0, device="cpu")
    # the families that raised here before they were ported take a step
    # (the MoE family with its router losses in the metrics)
    other = get_config(FAMILY_ARCHS[family], smoke=True)
    other_params = TR.init(other, 0, device="cpu")
    _, _, nstep, m = TS.build_train_step(other, opt, device="cpu")(
        other_params, opt.init(other_params), 0,
        family_batch(other, 2, 4))
    assert nstep == 1 and np.isfinite(float(m["loss"]))
    assert ("moe_aux" in m) == (family == "moe")
    from repro_torch.launch.serve import BatchedServer
    with pytest.raises(TypeError, match="Mesh"):
        BatchedServer(lm, lm_params, 2, 16, device="cpu", mesh=object())
    # the popcount mode of the binary engine is ported (#8): the folded
    # entry and the engine's dispatch run, equal to the MXU mode
    a = (torch.rand((2, 1, 4, 8), generator=torch.Generator().manual_seed(2))
         < 0.5).float()
    assert torch.equal(
        TO.binary_attention(a[0], a[0], a[0], scale=1.0, delta=2.0,
                            use_popcount=True),
        TO.binary_attention(a[0], a[0], a[0], scale=1.0, delta=2.0))
    assert torch.equal(
        TAt.spiking_attention(a, a, a, tcfg.spiking,
                              engine=TE.EngineConfig(binary="popcount")),
        TAt.spiking_attention(a, a, a, tcfg.spiking,
                              engine=TE.EngineConfig(binary="mxu_kernel")))
    # the quantized sparse spike_linear is ported (int8 kernels #3 / #5):
    # on both datapaths it runs, and its forward and gradient equal the
    # dense quantized reference's on spikes
    from repro_torch.quant import quantize_weight
    q = quantize_weight(torch.randn((8, 4), generator=torch.Generator(
        ).manual_seed(0)), dyadic=True)
    s = (torch.rand((2, 1, 4, 8), generator=torch.Generator().manual_seed(1))
         < 0.5).float()
    for path in ("tile", "decoded"):
        x = s.clone().requires_grad_()
        y = TE.spike_linear(q, x, engine=TE.EngineConfig(mode="sparse",
                                                         sparse=path))
        assert torch.equal(y, TE.dense_quant_linear(q, s))
        y.sum().backward()
        xd = s.clone().requires_grad_()
        TE.dense_quant_linear(q, xd).sum().backward()
        assert torch.equal(x.grad, xd.grad)


def test_train_step_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = get_config(ARCH, smoke=True)
    for call in (lambda: TS.build_train_step(tcfg, adamw(1e-3)),
                 lambda: TT.train(ARCH, True, 1, 2, 1e-3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
