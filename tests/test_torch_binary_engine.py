"""The port's popcount mode of the binary engine (``binary='popcount'``)
against the JAX package.

* ``popcount_scores_plain`` (what the wrapper runs on CPU tensors)
  equals the Pallas ``popcount_scores`` (interpret mode, as the JAX tests
  run it) bitwise: Lq and Lk that are not multiples of its 128-blocks,
  head dims 16 / 32 / 64 / 80 (a zero-padded last word), all-zero and
  all-one words; ``pack_bits``'s words equal JAX's;
  ``ops.popcount_attention_scores`` equals JAX's;
* ``ops.binary_attention(use_popcount=True)`` equals the jitted JAX one
  bitwise, causal or not, binarized or analog scores, and on the tie
  deltas where jitted XLA's contracted ``count * scale - delta`` and an
  eagerly evaluated one disagree (which a test pins); it equals the
  port's MXU mode bitwise; its gradients equal the MXU mode's bitwise
  and JAX's within 1e-5 of their scale;
* the slice: the SMOKE vision forwards on the mixed int8 tree (whose
  layers take the sequential composition) with ``overlap='off'`` and
  ``binary='popcount'`` bitwise against JAX's, and the plain version
  called once a layer; a SMOKE train step against the jitted JAX step;
  the mixed spikingformer-lm prefill (head_dim 16, a padded word) within
  1e-5 of JAX's; the bf16 LM prefill popcount == MXU mode;
* the launcher rejects operands the kernel does not take.

Counts and spikes are exact, so every comparison of the kernel's
function is bitwise. The CUDA kernel is held against the plain version
on the card by ``chip_smoke.py``.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bitpack as JB  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import popcount_attention as JPA  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.quant import quantize_tree as jquantize_tree  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import attention as TAt  # noqa: E402
from repro_torch.core import bitpack as TB  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import popcount_attention as TPA  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

from test_torch_fused_ssa import MIXED  # noqa: E402
from test_torch_lm import _params as _lm_params  # noqa: E402
from test_torch_lm import _select_qkv, _tokens  # noqa: E402
from test_torch_spike_kernels import DTYPES, _spikes  # noqa: E402
from test_torch_spikingformer import _setup  # noqa: E402
from test_torch_train import _check_train_step, _rel_close  # noqa: E402


def _packed(a):
    """numpy {0,1} -> (JAX uint32 words, port int32 words)."""
    return JB.pack_bits(jnp.asarray(a)), TB.pack_bits(torch.from_numpy(a))


# --- popcount_scores --------------------------------------------------------

# (BH, Lq, Lk): ragged against the Pallas kernel's 128-blocks, Lq != Lk
SCORE_SHAPES = [(2, 50, 70), (3, 130, 9), (1, 1, 200)]


@pytest.mark.parametrize("d", [16, 32, 64, 80])
@pytest.mark.parametrize("shape", range(len(SCORE_SHAPES)))
def test_popcount_scores_plain_bitwise_against_pallas_kernel(d, shape):
    bh, lq, lk = SCORE_SHAPES[shape]
    rng = np.random.default_rng(100 * d + shape)
    q, k = _spikes(rng, (bh, lq, d)), _spikes(rng, (bh, lk, d))
    q[0, 0] = 1.0                       # every bit of a row, bit 31 too
    k[0, -1] = 1.0
    (jq, tq), (jk, tk) = _packed(q), _packed(k)
    assert tq.shape == (bh, lq, -(-d // 32))
    np.testing.assert_array_equal(tq.numpy().view(np.uint32), np.asarray(jq))
    want = np.asarray(JPA.popcount_scores(jq, jk))
    got = TPA.popcount_scores(tq, tk)
    assert got.dtype == torch.int32 and got.shape == (bh, lq, lk)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.einsum("bqd,bkd->bqk", q, k))


def test_popcount_scores_on_all_zero_and_all_one_words():
    """Words of all zeros, all ones (bit 31, the int32 sign bit, set) and
    their mix, W = 3: counts 0, 96 and 0."""
    ones = np.full((2, 5, 3), 0xFFFFFFFF, np.uint32)
    zeros = np.zeros((2, 7, 3), np.uint32)
    for a, b in ((ones, ones[:, :4]), (ones, zeros), (zeros, zeros)):
        want = np.asarray(JPA.popcount_scores(jnp.asarray(a),
                                              jnp.asarray(b)))
        got = TPA.popcount_scores(torch.from_numpy(a.view(np.int32)),
                                  torch.from_numpy(b.view(np.int32)))
        np.testing.assert_array_equal(got.numpy(), want)
        assert set(np.unique(want)) <= {0, 96}


def test_popcount_attention_scores_matches_jax():
    rng = np.random.default_rng(7)
    q, k = _spikes(rng, (4, 33, 48)), _spikes(rng, (4, 21, 48))
    want = np.asarray(JO.popcount_attention_scores(jnp.asarray(q),
                                                   jnp.asarray(k)))
    got = TO.popcount_attention_scores(torch.from_numpy(q),
                                       torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 0


# --- binary_attention(use_popcount=True) ------------------------------------

def _jax_popcount(q, k, v, *, scale, delta, causal, binarize_scores=True):
    """The jitted JAX popcount forward (the JAX main paths are jitted)."""
    return np.asarray(jax.jit(lambda a, b, c: JO.binary_attention(
        a, b, c, scale=scale, delta=delta, causal=causal,
        binarize_scores=binarize_scores, use_popcount=True))(q, k, v))


# (bh, l, d, causal, delta, binarize): binary scores at d = 32 and 80 (a
# padded word), analog scores at d = 16 and 64, where the scale is a
# power of two and the context sums are exact
POPCOUNT_CASES = [(3, 20, 32, False, 0.4, True), (2, 37, 32, True, 0.9, True),
                  (2, 13, 80, True, -0.1, True), (2, 19, 16, False, 0.0, False),
                  (2, 23, 64, True, 0.0, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(POPCOUNT_CASES)))
def test_popcount_binary_attention_bitwise_against_jitted_jax(dtype, case):
    bh, l, d, causal, delta, binarize = POPCOUNT_CASES[case]
    rng = np.random.default_rng(20 + case)
    q, k, v = (_spikes(rng, (bh, l, d), p) for p in (0.4, 0.4, 0.5))
    jd, td = DTYPES[dtype]
    scale = 1.0 / math.sqrt(d)
    kw = dict(scale=scale, delta=delta, causal=causal,
              binarize_scores=binarize)
    want = _jax_popcount(*(jnp.asarray(a, jd) for a in (q, k, v)), **kw)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = TO.binary_attention(tq, tk, tv, use_popcount=True, **kw)
    mxu = TO.binary_attention(tq, tk, tv, **kw)
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert torch.equal(got, mxu)
    assert np.asarray(want, np.float32).std() > 0


def _tie_inputs(c, d=32, l=4):
    """Every query overlaps key 0 by exactly c and no other key."""
    q = np.zeros((1, l, d), np.float32)
    k = np.zeros_like(q)
    q[0, :, :c] = 1.0
    k[0, 0, :c] = 1.0
    return q, k, np.ones_like(q)


def _ties(d=32):
    """Counts whose fp32 product with 1/sqrt(d) rounds up: at delta =
    fl(c * scale) a separately rounded product passes the threshold and
    the fused multiply-add does not."""
    s32 = np.float32(1.0 / math.sqrt(d))
    return [c for c in range(1, d + 1)
            if np.float32(c) * s32 > np.float64(c) * np.float64(s32)]


def test_popcount_threshold_ties_follow_the_contracted_fma():
    """At the tie deltas the port's popcount mode equals the jitted JAX
    popcount path (XLA contracts ``counts * scale - delta`` into one FMA:
    the tie does not pass) and the port's MXU mode."""
    d = 32
    scale = 1.0 / math.sqrt(d)
    ties = _ties(d)
    assert ties[:6] == [5, 7, 10, 14, 15, 19]
    for c in ties:
        delta = float(np.float32(c) * np.float32(scale))
        q, k, v = _tie_inputs(c, d)
        want = _jax_popcount(q, k, v, scale=scale, delta=delta, causal=False)
        args = [torch.from_numpy(a) for a in (q, k, v)]
        got = TO.binary_attention(*args, scale=scale, delta=delta,
                                  use_popcount=True)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == 0).all(), c
        assert torch.equal(got, TO.binary_attention(*args, scale=scale,
                                                    delta=delta))


def test_eager_jax_popcount_path_rounds_the_threshold_apart():
    """The reference fact the port follows the jitted side of: called
    eagerly, JAX's popcount path rounds ``counts * scale`` and the
    difference apart, so at a tie delta the tie passes (every context
    entry is 1), while the jitted path does not."""
    d = 32
    scale = 1.0 / math.sqrt(d)
    for c in _ties(d)[:3]:
        delta = float(np.float32(c) * np.float32(scale))
        q, k, v = _tie_inputs(c, d)
        eager = np.asarray(JO.binary_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
            delta=delta, use_popcount=True))
        jitted = _jax_popcount(q, k, v, scale=scale, delta=delta,
                               causal=False)
        assert (eager == 1).all() and (jitted == 0).all(), c


@pytest.mark.parametrize("causal", [False, True])
def test_popcount_gradients_equal_mxu_mode_and_jax(causal):
    """The popcount forward with the oracle's surrogate backward: dq, dk,
    dv and d_delta equal the MXU mode's bitwise (the same recompute) and
    JAX's ``jax.grad`` of its popcount path within 1e-5 of their scale
    (sigmoid ulps and summation order)."""
    rng = np.random.default_rng(3)
    bh, l, d = 4, 13, 16
    q, k, v = (_spikes(rng, (bh, l, d)) for _ in range(3))
    c = rng.normal(0, 1, (bh, l, d)).astype(np.float32)
    delta = np.float32(0.3)
    scale = 1.0 / math.sqrt(d)

    def jloss(q_, k_, v_, d_):
        out = JO.binary_attention(q_, k_, v_, scale=scale, delta=d_,
                                  causal=causal, use_popcount=True)
        return (out * c).sum(), out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(q, k, v, delta)
    grads = {}
    for pop in (True, False):
        leaves = [torch.tensor(a).requires_grad_() for a in (q, k, v, delta)]
        out = TO.binary_attention(*leaves[:3], scale=scale, delta=leaves[3],
                                  causal=causal, use_popcount=pop)
        (out * torch.from_numpy(c)).sum().backward()
        grads[pop] = [t.grad for t in leaves]
        if pop:
            np.testing.assert_array_equal(out.detach().numpy(),
                                          np.asarray(jout))
    for name, a, b, want in zip("qkvΔ", grads[True], grads[False], jgrads):
        assert torch.equal(a, b), name
        _rel_close(a.numpy(), want, 1e-5, f"d{name}")
    assert np.abs(np.asarray(jgrads[0])).max() > 0


# --- the slice ---------------------------------------------------------------

POPCOUNT_OFF = dict(mode="sparse", binary="popcount", overlap="off")


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of ``popcount_scores_plain`` (the wrapper's CPU
    branch)."""
    calls = []
    real = TPA.popcount_scores_plain

    def spy(q, k):
        calls.append(tuple(q.shape))
        return real(q, k)
    monkeypatch.setattr(TPA, "popcount_scores_plain", spy)
    return calls


@pytest.mark.parametrize("arch", ["spikingformer-4-256",
                                  "spikingformer-8-512"])
def test_mixed_tree_forward_with_popcount_matches_jax(arch, plain_calls):
    """The SMOKE mixed int8 tree (int8 wo, w1, w2, head; fp wq, wk, wv):
    its layers are not eligible for the layer program, so under
    ``overlap='off'`` each takes the sequential composition, whose
    attention runs the popcount mode (one ``popcount_scores`` a layer).
    Logits bitwise equal to JAX's forward under the same engine (the
    Pallas popcount kernel in interpret mode, jitted), the port's MXU
    mode and the port's ``overlap='fused'`` (the bundle kernel's plain
    version). An eligible layer under ``overlap='off'`` runs the
    sequential oracle, in JAX and in the port: no popcount call."""
    jcfg, tcfg, params, state, batch = _setup(arch)
    jq = jax.tree_util.tree_map(np.asarray, jquantize_tree(
        params, "int8", dyadic=True, select=MIXED))
    with JE.use_engine(jcfg.engine.replace(**POPCOUNT_OFF)):
        want = np.asarray(jax.jit(
            lambda p, b, s: JR.forward(p, jcfg, b, state=s)[0])(
                jq, batch, state))
    assert np.isfinite(want).all() and want.std() > 0
    tp, ts, tb = (interop.to_torch(a, device="cpu")
                  for a in (jq, state, batch))
    got = {}
    for name, eng in (("popcount", POPCOUNT_OFF),
                      ("mxu", dict(POPCOUNT_OFF, binary="mxu_kernel")),
                      ("fused", dict(POPCOUNT_OFF, overlap="fused"))):
        plain_calls.clear()
        with TE.use_engine(tcfg.engine.replace(**eng)), \
                torch.inference_mode():
            got[name] = TR.forward(tp, tcfg, tb, state=ts)[0]
        want_calls = tcfg.num_layers if name == "popcount" else 0
        assert len(plain_calls) == want_calls, (name, plain_calls)
    np.testing.assert_array_equal(got["popcount"].numpy(), want)
    assert torch.equal(got["popcount"], got["mxu"])
    assert torch.equal(got["popcount"], got["fused"])
    # the fp tree's eligible layers: the oracle, no popcount call
    plain_calls.clear()
    with TE.use_engine(tcfg.engine.replace(**POPCOUNT_OFF)), \
            torch.inference_mode():
        TR.forward(interop.to_torch(params, device="cpu"), tcfg, tb,
                   state=ts)
    assert plain_calls == []


def test_train_step_with_popcount_against_the_jitted_jax_train_step():
    """binary='popcount' on both sides (the port's plain version, JAX's
    interpret-mode Pallas kernel under jit), the tolerances of
    ``test_torch_train.test_train_step_against_the_jitted_jax_train_step``."""
    _check_train_step(binary="popcount")


def test_lm_prefill_with_popcount_matches_jax(plain_calls):
    """spikingformer-lm SMOKE (head_dim 16: one zero-padded word a row)
    with the mixed int8 tree (int8 wq, wk, wv), whose layers take the
    sequential composition under ``overlap='off'``: the prefill step's
    logits with ``binary='popcount'`` (one ``popcount_scores`` a layer)
    within 1e-5 of JAX's forward under the same engine (the norms' rsqrt
    gap, as ``test_torch_lm``), and equal to the MXU mode bitwise. The
    bf16 tree's layers (not eligible either) likewise: popcount == MXU
    bitwise."""
    jcfg, cfg, jp = _lm_params()
    assert cfg.head_dim == 16
    jq = jax.tree_util.tree_map(np.asarray, jquantize_tree(
        jp, "int8", select=_select_qkv))
    toks = _tokens(jcfg, 2, 11, seed=5)
    jcfg = jcfg.replace(engine=jcfg.engine.replace(**POPCOUNT_OFF))
    with JE.use_engine(jcfg.engine):
        want = np.asarray(jax.jit(lambda p, t: JR.forward(
            p, jcfg, {"tokens": t})[0])(jq, toks))
    assert np.isfinite(want).all() and want.std() > 0
    batch = {"tokens": torch.from_numpy(toks)}
    bcfg = cfg.replace(dtype="bfloat16")
    for tree, c in ((interop.to_torch(jq, device="cpu"), cfg),
                    (TR.init(bcfg, 0, device="cpu"), bcfg)):
        got = {}
        for binary in ("popcount", "mxu_kernel"):
            plain_calls.clear()
            eng = c.engine.replace(**dict(POPCOUNT_OFF, binary=binary))
            got[binary] = TS.build_prefill_step(
                c.replace(engine=eng), device="cpu")(tree, batch)
            assert len(plain_calls) == (cfg.num_layers
                                        if binary == "popcount" else 0)
        assert torch.equal(got["popcount"], got["mxu_kernel"])
        if c is cfg:
            np.testing.assert_allclose(got["popcount"].numpy(), want,
                                       rtol=0, atol=1e-5)


def test_spiking_attention_routes_popcount_to_the_kernel(plain_calls):
    """An explicit 'popcount' engine reaches the wrapper on CPU tensors
    (one call, the plain version) and equals the oracle."""
    rng = np.random.default_rng(1)
    s = torch.from_numpy(_spikes(rng, (2, 3, 9, 16)))
    cfg = get_config("spikingformer-4-256", smoke=True).spiking
    got = TAt.spiking_attention(s, s, s, cfg, delta_score=0.5,
                                engine=TE.EngineConfig(binary="popcount"))
    want = TAt.spiking_attention(s, s, s, cfg, delta_score=0.5,
                                 engine=TE.EngineConfig(binary="jnp"))
    assert plain_calls == [(6, 9, 1), ] and torch.equal(got, want)


# --- the launcher -------------------------------------------------------------


@pytest.mark.parametrize("case", ["dtype", "words", "bh", "rank",
                                  "contiguous", "device"])
def test_popcount_launcher_rejects_operands_before_launching(case):
    """Each bad operand raises ValueError before any build or launch, and
    the wrapper never finishes a non-CPU tensor on the CPU."""
    q = torch.zeros((2, 5, 2), dtype=torch.int32)
    k = torch.zeros((2, 7, 2), dtype=torch.int32)
    bad = {"dtype": (q.float(), k, "int32 words"),
           "words": (q, k[..., :1], "takes"),
           "bh": (q, k[:1], "takes"),
           "rank": (q[0], k[0], "takes"),
           "contiguous": (q, torch.zeros((2, 2, 7), dtype=torch.int32
                                         ).transpose(1, 2), "contiguous")}
    if case == "device":
        qm = q.to("meta")
        with pytest.raises(ValueError, match="CPU or CUDA"):
            TPA.popcount_scores(qm, k.to("meta"))
    else:
        a, b, msg = bad[case]
        with pytest.raises(ValueError, match=msg):
            TPA.popcount_scores_cuda(a, b)
        if case != "contiguous":
            with pytest.raises(ValueError, match=msg):
                TPA.popcount_scores(a, b)
    assert "popcount_attention" in _build.SOURCES
    assert TPA.LAUNCHES["popcount_scores"] == 0
