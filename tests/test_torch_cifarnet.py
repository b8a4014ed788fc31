"""The port's CIFAR-Net (FireFly v2's spiking conv network) against the
JAX package.

JAX params of the SMOKE config (16x16 images, T=2) rounded to the 2^-8
grid, dyadic BN affines and means, variances where XLA's and torch's
rsqrt agree, and images k/256, converted by ``repro_torch.interop``:

* the config mirror, the init / init_state tree layouts and dtypes;
* ``registry.forward`` in eval mode: logits bitwise, the BN state passed
  through; in train mode: logits and fire rate bitwise, the new running
  means and variances within 1e-6 of each leaf's scale, as
  ``test_torch_train.py`` holds train-mode BN (the variance, and the
  first conv's mean, whose sum of image-by-weight products is not exact,
  are fp32 sums in another order than XLA's; the update itself is
  contracted as XLA contracts it);
* ``layer_sparsities`` to 1e-6;
* one AdamW train step within ``test_torch_train.py``'s tolerances
  (``_torch_train_helpers``);
* the interop round trip, and that ``init`` without a device raises
  when CUDA is absent.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

from _torch_helpers import agreeing_variances, dyadic  # noqa: E402
from _torch_train_helpers import check_train_step, rel_close  # noqa: E402

ARCH = "cifarnet"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Hundreds of small CPU ops a test: with other test workers on the
    machine, torch's thread pool spins against them, so run on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(seed=0, batch=2):
    """(JAX cfg, port cfg, numpy params, numpy BN state, numpy batch)."""
    cfg = jget_config(ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    params = _np_tree(jax.tree_util.tree_map(
        lambda a: jnp.round(a * 256) / 256,
        JR.init(cfg, jax.random.PRNGKey(seed))))
    for bn in [c["bn"] for c in params["convs"]]:
        bn["scale"] = (1.0 + dyadic(rng, bn["scale"].shape) * 0.5
                       ).astype(bn["scale"].dtype)
        bn["bias"] = (0.25 + dyadic(rng, bn["bias"].shape) * 0.5
                      ).astype(bn["bias"].dtype)
    state = _np_tree(JR.init_state(cfg))
    for st in state["convs"]:
        st["mean"] = dyadic(rng, st["mean"].shape) * 0.25
        st["var"] = agreeing_variances(rng, st["var"].size)
    v = cfg.vision
    images = (rng.integers(0, 256, (batch, v.img_size, v.img_size,
                                    v.in_channels)) / 256.0
              ).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (batch,)).astype(np.int32)
    return (cfg, get_config(ARCH, smoke=True), params, state,
            {"images": images, "labels": labels})


@pytest.mark.parametrize("smoke", [False, True])
def test_config_mirrors_jax_field_by_field(smoke):
    jcfg, tcfg = jget_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(tcfg):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if dataclasses.is_dataclass(got):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert tcfg.engine is None


def test_init_and_state_layout_match_jax():
    cfg = jget_config(ARCH, smoke=True)
    tcfg = get_config(ARCH, smoke=True)
    for jtree, ttree in ((JR.init(cfg, jax.random.PRNGKey(0)),
                          TR.init(tcfg, 0, device="cpu")),
                         (JR.init_state(cfg),
                          TR.init_state(tcfg, device="cpu"))):
        jl, jdef = jax.tree_util.tree_flatten(jtree)
        tl, tdef = jax.tree_util.tree_flatten(interop.to_numpy(ttree))
        assert jdef == tdef
        for j, t in zip(jl, tl):
            assert np.shape(j) == t.shape and np.asarray(j).dtype == t.dtype
    full = get_config(ARCH)
    p = TR.init(full, 0, device="meta")
    assert [c["conv"]["w"].shape[-1] for c in p["convs"]] == \
        [32, 256, 256, 256, 256, 256, 512, 1024]
    assert p["head"]["w"].shape == (1024, 10)
    assert p["head"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("train", [False, True])
def test_forward_bitwise_against_jitted_jax(train):
    cfg, tcfg, params, state, batch = _setup()
    images = {"images": batch["images"]}
    want, jaux = jax.jit(lambda p, b, s: JR.forward(
        p, cfg, b, train=train, state=s))(params, images, state)
    want = np.asarray(want)
    assert np.isfinite(want).all() and want.std() > 0
    logits, aux = TR.forward(interop.to_torch(params, device="cpu"), tcfg,
                             interop.to_torch(images, device="cpu"),
                             train=train,
                             state=interop.to_torch(state, device="cpu"))
    np.testing.assert_array_equal(logits.numpy(), want)
    assert float(aux["fire_rate"]) == float(jaux["fire_rate"])
    assert 0 < float(aux["fire_rate"]) < 1
    jl = jax.tree_util.tree_leaves(jaux["state"])
    tl = jax.tree_util.tree_leaves(interop.to_numpy(aux["state"]))
    assert len(jl) == len(tl) == 2 * 8
    for j, t in zip(jl, tl):
        if train:
            rel_close(t, j, 1e-6, "BN state")
        else:
            np.testing.assert_array_equal(t, np.asarray(j))


def test_layer_sparsities_match_jax():
    from repro.models.spikingformer import layer_sparsities as jsparsities
    from repro_torch.models.spikingformer import layer_sparsities
    cfg, tcfg, params, state, batch = _setup(seed=2)
    images = {"images": batch["images"]}
    want = jsparsities(params, cfg, images, state)
    got = layer_sparsities(interop.to_torch(params, device="cpu"), tcfg,
                           interop.to_torch(images, device="cpu"),
                           interop.to_torch(state, device="cpu"))
    assert [n for n, _ in got] == [f"conv{i}" for i in range(8)]
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=1e-6)
    assert all(0 < v < 1 for _, v in got)


def test_train_step_against_the_jitted_jax_train_step():
    cfg, tcfg, params, state, batch = _setup(seed=1, batch=4)
    loss = check_train_step(cfg, tcfg, params, state, batch)
    assert np.isfinite(loss)


def test_interop_round_trip_and_cpu_entry_points(monkeypatch):
    """The cifarnet tree and its BN state cross to the port and back leaf
    for leaf; without CUDA, init / init_state without a device raise."""
    cfg, tcfg, params, state, _ = _setup()
    for tree in (params, state):
        back = interop.to_numpy(interop.to_torch(tree, device="cpu"))
        jl, jdef = jax.tree_util.tree_flatten(tree)
        bl, bdef = jax.tree_util.tree_flatten(back)
        assert jdef == bdef
        for a, b in zip(jl, bl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    bf = jax.tree_util.tree_map(np.asarray, JR.init(
        jget_config(ARCH, smoke=True).replace(dtype="bfloat16"),
        jax.random.PRNGKey(0)))
    tbf = interop.to_torch(bf, device="cpu")
    assert tbf["convs"][3]["conv"]["w"].dtype == torch.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(bf),
                    jax.tree_util.tree_leaves(interop.to_numpy(tbf))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int16), b.view(np.int16))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TR.init(tcfg, 0), lambda: TR.init_state(tcfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
