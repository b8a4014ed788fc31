"""The port's hybrid family (``repro_torch.models.hybrid`` and ``ssm``:
hymba-1.5b, GQA attention beside a selective-SSM branch) against the JAX
package at the SMOKE size (fp32), on numpy-seeded inputs and JAX's own
parameters (``repro.models.registry.init`` through ``interop``).

Tolerances, and why:
* the selective scan (``ssm_forward``: output, state, conv buffer) and
  ``causal_depthwise_conv1d`` within REL = 1e-6 of the largest
  magnitude: fp32 products summed in another order (XLA contracts the
  recurrence's ``da * h + dbx`` into one FMA; the port rounds twice), a
  few ulps of the largest term; the conv buffer bitwise (a slice of the
  projection);
* ``softplus`` within 2 fp32 ulps of ``jax.nn.softplus`` (torch's and
  XLA's exp / log1p);
* logits of forwards and decode steps within LOGIT_ATOL = 2e-5,
  ``test_torch_dense.py``'s tolerance (rmsnorm's rsqrt, the softmax
  attention, the scan and the projections round apart from XLA's
  through 2 layers); the decode against the forward within the same;
* one train step with ``tests/_torch_train_helpers.check_train_step``'s
  tolerances; int8 codes and scales bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.spiking import SpikingConfig as JSpikingConfig  # noqa: E402
from repro.models import nn as JN  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.quant import quantize_tree as jquantize_tree  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.spiking import SpikingConfig  # noqa: E402
from repro_torch.kernels import spike_attention as TSA  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.quant import quantize_tree  # noqa: E402

from _torch_train_helpers import check_train_step, rel_close  # noqa: E402

ARCH = "hymba-1.5b"
LOGIT_ATOL = 2e-5
REL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def _setup(spiking_t=None):
    """(jcfg, cfg, JAX params as numpy, the port's tensors), cached;
    ``spiking_t``: the config in spiking mode with T = spiking_t."""
    if spiking_t not in _SETUPS:
        jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH,
                                                               smoke=True)
        if spiking_t is not None:
            jcfg = jcfg.replace(spiking=JSpikingConfig(time_steps=spiking_t))
            cfg = cfg.replace(spiking=SpikingConfig(time_steps=spiking_t))
        jp = jax.tree_util.tree_map(
            np.asarray, JR.init(jcfg, jax.random.PRNGKey(0)))
        _SETUPS[spiking_t] = (jcfg, cfg, jp, interop.to_torch(jp,
                                                               device="cpu"))
    return _SETUPS[spiking_t]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def test_config_and_init_mirror_jax():
    """CONFIG and SMOKE field by field (the SSM config too), the arch in
    ``ALL_ARCHS``; the init tree has JAX's layout, shapes and dtypes in
    fp32 and bf16 (A_log and D fp32), a spiking one with ``delta``."""
    from repro_torch.configs import ALL_ARCHS
    assert ARCH in ALL_ARCHS
    for smoke in (False, True):
        j, t = jget_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in t.__dataclass_fields__:
            a, b = getattr(t, f), getattr(j, f)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f
    jcfg, cfg, _, _ = _setup()
    for jc, tc in ((jcfg, cfg), (jcfg.replace(dtype="bfloat16"),
                                 cfg.replace(dtype="bfloat16")),
                   (jcfg.replace(spiking=JSpikingConfig(time_steps=2)),
                    cfg.replace(spiking=SpikingConfig(time_steps=2)))):
        want = jax.eval_shape(lambda: JR.init(jc, jax.random.PRNGKey(0)))
        mine = interop.to_numpy(registry.init(tc, 3, device="cpu"))
        assert jax.tree_util.tree_structure(want) == \
            jax.tree_util.tree_structure(mine)
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(mine)):
            assert a.shape == b.shape and a.dtype == b.dtype
        assert mine["layers"]["mamba"]["A_log"].dtype == np.float32


def test_softplus_and_causal_conv_match_jax():
    """``softplus`` on values past F.softplus's threshold of 20 and below
    -20, and the causal depthwise conv, against JAX's."""
    x = np.linspace(-40, 40, 801).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(x))
    got = TSSM.softplus(torch.from_numpy(x)).numpy()
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()
    rng = np.random.default_rng(5)
    xs = rng.normal(0, 1, (2, 13, 24)).astype(np.float32)
    w = rng.normal(0, 0.5, (4, 24)).astype(np.float32)
    want = np.asarray(jax.jit(JN.causal_depthwise_conv1d)(xs, w))
    got = nn.causal_depthwise_conv1d(torch.from_numpy(xs),
                                     torch.from_numpy(w))
    rel_close(got.numpy(), want, REL, "conv")


def test_selective_scan_matches_jax():
    """Layer 0's mamba branch on 2 x 13 tokens from the zero state, then
    3 more tokens continuing from its state and conv buffer (the decode
    path's call) against JAX's ``ssm_forward``."""
    jcfg, cfg, jp, tp = _setup()
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["mamba"])
    tm = interop.to_torch(jm, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32)
    jf = jax.jit(lambda p, x, h, c: JSSM.ssm_forward(p, x, jcfg, h, c))
    jy, jh, jc = jax.jit(lambda p, x: JSSM.ssm_forward(p, x, jcfg))(
        jm, x[:, :13])
    ty, th, tc = TSSM.ssm_forward(tm, torch.from_numpy(x[:, :13]), cfg)
    for got, want, what in ((ty, jy, "y"), (th, jh, "state")):
        rel_close(got.numpy(), want, REL, what)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jy2, jh2, jc2 = jf(jm, x[:, 13:], jh, jc)
    ty2, th2, tc2 = TSSM.ssm_forward(tm, torch.from_numpy(x[:, 13:]), cfg,
                                     state=th, conv_state=tc)
    for got, want, what in ((ty2, jy2, "y"), (th2, jh2, "state"),
                            (tc2, jc2, "conv")):
        rel_close(got.numpy(), want, REL, what)


def test_forward_logits_match_jax():
    """2 x 20 tokens through ``build_prefill_step``; ``inputs_embeds`` in
    place of the lookup gives the same."""
    jcfg, cfg, jp, tp = _setup()
    tok = _tokens(cfg, (2, 20), 1)
    jl, _ = jax.jit(lambda p, t: JR.forward(p, jcfg, {"tokens": t}))(jp, tok)
    got = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float32 and got.shape == jl.shape
    _close(got, jl, LOGIT_ATOL)
    from repro_torch.models import hybrid as TH
    embeds = tp["embed"]["table"][torch.from_numpy(tok).long()]
    again, _ = TH.forward(tp, cfg, {"tokens": None}, inputs_embeds=embeds)
    assert torch.equal(again, got)


@pytest.mark.parametrize("max_len", [24, 6])
def test_token_by_token_decode_matches_jax(max_len):
    """JAX's ``test_decode_matches_forward`` case (2 rows, 10 tokens)
    through ``build_serve_step`` against JAX's steps: logits within
    LOGIT_ATOL, the ring's tags equal, K / V, SSM state and conv buffer
    close. With a cache of 24 the steps also equal the forward; with a
    ring of 6 (slot ``pos % 6``) the later steps see only the last 6
    keys, in both packages, and differ from the forward."""
    jcfg, cfg, jp, tp = _setup()
    tok = _tokens(cfg, (2, 10), 1)
    jcache = JR.init_cache(jcfg, 2, max_len)
    cache = registry.init_cache(cfg, 2, max_len, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos: JR.decode_step(p, jcfg, c, t, pos))
    step = steps.build_serve_step(cfg, device="cpu")
    outs = []
    for i in range(10):
        jl, jcache = jstep(jp, jcache, tok[:, i:i + 1], i)
        tl, cache = step(tp, cache, torch.from_numpy(tok[:, i:i + 1]), i)
        _close(tl, jl, LOGIT_ATOL)
        outs.append(tl)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for key in ("k", "v", "ssm", "conv"):
        _close(cache[key], jcache[key], LOGIT_ATOL)
    pre = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(tok)})
    diff = float((torch.cat(outs, dim=1) - pre).abs().max())
    if max_len >= 10:
        assert diff <= LOGIT_ATOL
    else:
        assert diff > 1e-3
    with pytest.raises(TypeError, match="n_tok"):
        registry.decode_step(tp, cfg, cache, torch.from_numpy(tok[:, :1]),
                             0, n_tok=torch.ones(2))


def test_spiking_hybrid_refused_and_jax_decode_departs():
    """JAX's spiking hymba (SMOKE, T = 2) feeds its analog rotated q / k /
    v to the binary attention in the forward and decodes with a softmax:
    its forward is finite, and its first decode step's logits lie more
    than 1 from the forward's first position. The port refuses both with
    a ValueError naming ROADMAP queue 3 and launches no kernel."""
    jcfg, cfg, jp, tp = _setup(2)
    tok = _tokens(cfg, (2, 6), 3)
    jl, _ = jax.jit(lambda p, t: JR.forward(p, jcfg, {"tokens": t}))(jp, tok)
    assert np.isfinite(np.asarray(jl)).all()
    jd, _ = jax.jit(lambda p, c, t: JR.decode_step(p, jcfg, c, t, 0))(
        jp, JR.init_cache(jcfg, 2, 8), tok[:, :1])
    assert np.abs(np.asarray(jd)[:, 0] - np.asarray(jl)[:, 0]).max() > 1.0
    before = dict(TSA.LAUNCHES)
    with pytest.raises(ValueError, match="ROADMAP queue 3"):
        steps.build_prefill_step(cfg, device="cpu")(
            tp, {"tokens": torch.from_numpy(tok)})
    with pytest.raises(ValueError, match="ROADMAP queue 3"):
        registry.decode_step(tp, cfg, registry.init_cache(cfg, 2, 8,
                                                          device="cpu"),
                             torch.from_numpy(tok[:, :1]), 0)
    assert TSA.LAUNCHES == before


def test_train_step_matches_jax():
    """One AdamW step of hymba-1.5b SMOKE on 2 x 10 tokens against the
    jitted JAX step: loss, gradients (the SSM's A_log and D too), grad
    norm, params."""
    jcfg, cfg, jp, _ = _setup()
    check_train_step(jcfg, cfg, jp, None, {"tokens": _tokens(cfg, (2, 10),
                                                             9)})


def test_quantize_tree_int8_leaves_match_jax():
    """``quantize_tree(..., 'int8')``: JAX's int8 leaves (attention, the
    SSM's projections, the MLP, the head; conv_w, A_log and D stay fp),
    codes and scales bitwise; the int8 forward within LOGIT_ATOL of
    JAX's. ``BatchedServer`` refuses the family in both packages."""
    from repro.launch import serve as JS
    jcfg, cfg, jp, tp = _setup()
    jq = jax.tree_util.tree_map(np.asarray, jquantize_tree(jp, "int8"))
    tq = interop.to_numpy(quantize_tree(tp, "int8"))
    assert jax.tree_util.tree_structure(jq) == \
        jax.tree_util.tree_structure(tq)
    paths = lambda t: sorted(jax.tree_util.keystr(p) for p, leaf in
                             jax.tree_util.tree_flatten_with_path(t)[0]
                             if leaf.dtype == np.int8)
    assert paths(tq) == paths(jq) and len(paths(tq)) == 12
    for a, b in zip(jax.tree_util.tree_leaves(jq),
                    jax.tree_util.tree_leaves(tq)):
        np.testing.assert_array_equal(a, b)
    tok = _tokens(cfg, (2, 8), 4)
    jl, _ = jax.jit(lambda p, t: JR.forward(p, jcfg, {"tokens": t}))(jq, tok)
    tl, _ = registry.forward(interop.to_torch(tq, device="cpu"), cfg,
                             {"tokens": torch.from_numpy(tok)})
    _close(tl, jl, LOGIT_ATOL)
    with pytest.raises(ValueError, match="slot"):
        JS.BatchedServer(jcfg, jp, 2, 16)
    with pytest.raises(ValueError, match="slot"):
        TSV.BatchedServer(cfg, tp, 2, 16, device="cpu")
