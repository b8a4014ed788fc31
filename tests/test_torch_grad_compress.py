"""The port's int8 gradient compression (``optim.grad_compress``) against
the JAX package.

* ``int8_compress`` / ``int8_decompress`` and ``compressed_gradients``
  bitwise against *eager* JAX over three rounds of error feedback, on
  fp32 and bf16 leaves. Jitted JAX multiplies by fl(1 / 127) where the
  port and eager JAX divide (ROADMAP queue 3), so the scale may land an
  ulp apart under jit;
* one compressed SMOKE step of spikingformer-lm against the jitted JAX
  step (``build_train_step(cfg, opt, compress=True)``), within bounds
  derived from the quantizer: each side's dequantized gradient lies
  within half its step s of the gradient it rounds, so the two lie
  within (s_port + s_jax) / 2 + |g_port - g_jax| of each other (an entry
  may land one step apart where the scales or the gradients differ),
  and the residuals g - deq within that plus |g_port - g_jax|; params
  within ``_torch_train_helpers``' AdamW bound on those gradients.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402

from _torch_train_helpers import SCHED, adamw_bound  # noqa: E402
from test_torch_lm_train import _lm_setup  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad_tree(rng, dtype):
    """A gradient tree of a few shapes, an outlier per leaf so the
    scales differ, a 0-d leaf and an all-zero one (the epsilon floor)."""
    def leaf(shape, spread):
        g = rng.normal(0, spread, shape).astype(np.float32)
        if g.size:
            g.flat[rng.integers(g.size)] *= 8
        return g.astype(dtype)
    return {"a": {"w": leaf((7, 5), 1e-2), "b": leaf((5,), 3.0)},
            "c": [leaf((3, 4, 6), 1e-6), leaf((), 0.5)],
            "z": np.zeros((4,), dtype)}


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_compressed_gradients_bitwise_against_eager_jax(dtype):
    rng = np.random.default_rng(11)
    first = _grad_tree(rng, dtype)
    jerr = JO.compress_state_init(first)
    terr = TO.compress_state_init(interop.to_torch(first, device="cpu"))
    for _ in range(3):
        grads = _grad_tree(rng, dtype)
        jdeq, jerr = JO.compressed_gradients(
            jax.tree_util.tree_map(jnp.asarray, grads), jerr)
        tdeq, terr = TO.compressed_gradients(
            interop.to_torch(grads, device="cpu"), terr)
        for want, got in zip(jax.tree_util.tree_leaves((jdeq, jerr)),
                             jax.tree_util.tree_leaves(
                                 interop.to_numpy((tdeq, terr)))):
            assert np.asarray(want).dtype == got.dtype
            np.testing.assert_array_equal(np.asarray(want, np.float32),
                                          np.asarray(got, np.float32))
    for g in jax.tree_util.tree_leaves(grads):
        q, s = JO.int8_compress(jnp.asarray(g))
        tq, ts = TO.int8_compress(interop.to_torch(g, device="cpu"))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        assert float(ts) == float(s)
        np.testing.assert_array_equal(
            TO.int8_decompress(tq, ts).numpy(),
            np.asarray(JO.int8_decompress(q, s)))


def test_compressed_lm_step_against_the_jitted_jax_step():
    cfg, tcfg, params, batch = _lm_setup()
    jopt, topt = jadamw(jwarmup_cosine(*SCHED)), TO.adamw(
        TO.warmup_cosine(*SCHED))
    jo = jopt.init(params)
    jo["compress_err"] = JO.compress_state_init(params)
    jp, jo, _, jm = jax.jit(JS.build_train_step(cfg, jopt, compress=True))(
        params, jo, jnp.asarray(0, jnp.int32), batch)

    def jloss(p):
        with JE.engine_scope(cfg):
            logits, _ = JR.forward(p, cfg, batch, train=True)
        return JS.loss_from_forward(cfg, logits, batch)
    jg = jax.jit(jax.grad(jloss))(params)
    jdeq, jerr = jax.jit(JO.compressed_gradients)(
        jg, JO.compress_state_init(params))

    tp = interop.to_torch(params, device="cpu")
    to = topt.init(tp)
    to["compress_err"] = TO.compress_state_init(tp)
    step = TS.build_train_step(tcfg, topt, compress=True, device="cpu")
    np_, no, nstep, tm = step(tp, to, 0, batch)
    assert nstep == 1 and set(tm) == {"loss", "grad_norm"}
    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    loss, _, tg = TS.value_and_grad(tcfg, tp, tb)
    assert float(loss) == float(tm["loss"])
    tdeq, terr = TO.compressed_gradients(tg, TO.compress_state_init(tp))

    leaves = lambda t: [np.asarray(a, np.float64) for a in
                        jax.tree_util.tree_leaves(t)]
    tleaves = lambda t: leaves(interop.to_numpy(t))
    lr0 = float(TO.warmup_cosine(*SCHED)(0))
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    sq = 0.0
    for (g_j, g_t, d_j, d_t, e_j, e_t, e_step, p_j, p_t) in zip(
            leaves(jg), tleaves(tg), leaves(jdeq), tleaves(tdeq),
            leaves(jerr), tleaves(terr), tleaves(no["compress_err"]),
            leaves(jp), tleaves(np_)):
        # the steps of each side's quantizer
        s_j = max(np.abs(g_j).max(), 1e-12) / 127
        s_t = max(np.abs(g_t).max(), 1e-12) / 127
        dg = np.abs(g_t - g_j)
        bound = (s_j + s_t) / 2 * (1 + 1e-6) + dg
        assert (np.abs(d_t - d_j) <= bound).all()
        assert (np.abs(e_t - e_j) <= bound + dg).all()
        np.testing.assert_array_equal(e_step, e_t)
        sq += float((bound ** 2).sum())
        err = np.abs(p_t - p_j)
        assert (err <= 5e-5 + adamw_bound(d_j, d_t, clip, lr0)).all()
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        np.sqrt(sq) + 1e-6 * float(jm["grad_norm"])
    for e_j, e in zip(leaves(jo["compress_err"]), leaves(jerr)):
        np.testing.assert_array_equal(e_j, e)
    # compression changes the step: the params differ from an
    # uncompressed step's
    plain = TS.build_train_step(tcfg, topt, device="cpu")(
        tp, topt.init(tp), 0, batch)[0]
    assert any(not np.array_equal(a, b) for a, b in zip(tleaves(plain),
                                                        tleaves(np_)))
