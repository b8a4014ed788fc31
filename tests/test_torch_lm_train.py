"""Training the port's spikingformer-lm against the JAX package, at the
SMOKE size on the CPU.

* ``SyntheticLM`` batches bitwise equal to JAX's, over several steps and
  shards, and ``make_pipeline(kind='lm')``;
* the token family's loss (``loss_from_forward``: each position's logits
  against the next token) within 1e-6 relative of JAX's on the same
  logits (a log-softmax over the vocabulary summed in another order);
* one SMOKE train step against the jitted JAX step with
  ``tests/_torch_train_helpers.check_train_step`` (its tolerances; the
  token family's loss within ``DENSE_LOSS_REL``), on each route the
  step can take:

  - fp32, eligible for the layer program: on the CPU ``overlap='auto'``
    resolves to 'off', so the port differentiates ``reference_layer``
    under autograd, which is what jitted JAX runs;
  - fp32 with ``spiking.binarize_context=True``, which sends both
    packages down the sequential composition with the binary engine's
    kernel mode (#7's plain version here, the interpret-mode Pallas
    kernel in JAX): the flag changes the route and not the function
    (ROADMAP queue 3);
  - the same composition with ``binary='popcount'`` (#8's plain
    version);
  - int8 QAT, on masters whose per-column scales are powers of two
    (jitted JAX multiplies by the reciprocal scale, ROADMAP queue 3);

* the step is refused nowhere: ``layer_step_causal(train=True)`` runs
  the layer program under 'fused' with the gradients of 'off'.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import make_pipeline as jmake_pipeline  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, make_pipeline  # noqa
from repro_torch.kernels import popcount_attention as PA  # noqa: E402
from repro_torch.kernels import spike_attention as SA  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from _torch_train_helpers import check_train_step  # noqa: E402
from test_torch_qat import qat_masters  # noqa: E402

ARCH = "spikingformer-lm"
BATCH, SEQ = 2, 12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small CPU ops a test: run torch on one thread beside the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shards", [1, 2])
def test_synthetic_lm_batches_match_jax(shards):
    for shard in range(shards):
        kw = dict(kind="lm", global_batch=4, seq_len=17, vocab_size=64,
                  seed=5, shard_index=shard, num_shards=shards)
        want = jmake_pipeline(JDataConfig(**kw))
        got = make_pipeline(DataConfig(**kw))
        assert isinstance(got, SyntheticLM)
        np.testing.assert_array_equal(got.next_tokens, want.next_tokens)
        for step in (0, 1, 7):
            w, g = want.batch_at(step), got.batch_at(step)
            assert set(g) == {"tokens"} and g["tokens"].dtype == np.int32
            assert g["tokens"].shape == (4 // shards, 17)
            np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_token_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (3, 9, 64)).astype(np.float32)
    tokens = rng.integers(0, 64, (3, 9)).astype(np.int32)
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    want = float(JS.loss_from_forward(jcfg, logits, {"tokens": tokens}))
    got = float(TS.loss_from_forward(cfg, torch.from_numpy(logits),
                                     {"tokens": torch.from_numpy(tokens)}))
    assert abs(got - want) <= 1e-6 * abs(want)


def _lm_setup(spiking=None, **engine):
    """JAX and port SMOKE configs (the engine and SpikingConfig fields
    given replaced), numpy params of JAX's init rounded to k/256 and one
    batch of the token stream."""
    cfgs = []
    for c in (jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)):
        cfgs.append(c.replace(
            engine=c.engine.replace(**engine),
            spiking=dataclasses.replace(c.spiking, **(spiking or {}))))
    cfg, tcfg = cfgs
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(np.round(np.asarray(a) * 256) / 256,
                             np.asarray(a).dtype),
        JR.init(cfg, jax.random.PRNGKey(0)))
    batch = jmake_pipeline(JDataConfig(
        kind="lm", global_batch=BATCH, seq_len=SEQ,
        vocab_size=cfg.vocab_size)).batch_at(0)
    return cfg, tcfg, params, batch


def _lm_linears(params):
    lay = params["layers"]
    return [lay[n] for n in ("wq", "wk", "wv", "wo")] + [
        lay["mlp"]["up"], lay["mlp"]["down"], params["lm_head"]]


ROUTES = {
    "eligible": dict(),
    "sequential": dict(spiking=dict(binarize_context=True),
                       binary="mxu_kernel"),
    "popcount": dict(spiking=dict(binarize_context=True), binary="popcount"),
    "qat int8": dict(),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_lm_train_step_against_the_jitted_jax_step(route, monkeypatch):
    """Also counts the port's calls of #7's and #8's plain versions: two
    forwards (the step's, then ``value_and_grad``'s) of one binary
    attention a layer on the sequential routes, none where the layers
    are eligible (``reference_layer`` computes its own attention)."""
    calls = {"spike_attention": 0, "popcount_scores": 0}
    for mod, name in ((SA, "spike_attention"), (PA, "popcount_scores")):
        real = getattr(mod, f"{name}_plain")

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, f"{name}_plain", counted)
    cfg, tcfg, params, batch = _lm_setup(**ROUTES[route])
    qat = None
    if route == "qat int8":
        qat = "int8"
        params = qat_masters(params, qat, seed=5, linears=_lm_linears)
    loss = check_train_step(cfg, tcfg, params, None, batch, qat=qat)
    assert np.isfinite(loss) and loss > 0
    want = dict.fromkeys(calls, 0)
    if route in ("sequential", "popcount"):
        key = "popcount_scores" if route == "popcount" else "spike_attention"
        want[key] = 2 * tcfg.num_layers
    assert calls == want


def test_layer_step_causal_trains_through_the_layer_program():
    """Train mode is refused nowhere: an eligible layer under 'fused'
    runs the layer program (its plain version here) behind
    ``_FusedLayer``, with the outputs and gradients of 'off'."""
    cfg, tcfg, params, batch = _lm_setup()
    tp = interop.to_torch(params, device="cpu")
    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    runs = {}
    for overlap in ("off", "fused"):
        c = tcfg.replace(engine=tcfg.engine.replace(overlap=overlap))
        loss, _, grads = TS.value_and_grad(c, tp, tb)
        runs[overlap] = [loss] + tree_leaves(grads)
    assert all(torch.equal(a, b) for a, b in zip(runs["off"],
                                                  runs["fused"]))
    assert all(float(g.abs().sum()) > 0 for g in runs["off"][1:])
    lp = tree_map(lambda a: a[0], tp["layers"])
    x = torch.randn((2, 1, 5, tcfg.d_model))
    y = E.layer_step_causal(lp, tcfg, x, torch.arange(5), train=True,
                            engine=tcfg.engine.replace(overlap="fused"))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
