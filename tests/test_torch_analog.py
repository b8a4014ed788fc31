"""Spikingformer's own analog SSA (``binarize_scores=False``) in the port
against the JAX package.

Analog scores are Spikformer / Spikingformer Eq. 2 with no threshold:
``fl(count * scale)`` of the {0,1} q / k counts. The port sums the
context of such scores over the keys in ascending order, one fp32 add a
term (``kernels.fused_ssa.analog_context``), which is the CUDA kernels'
order; XLA sums in its own. At head_dim 16 (scale 1/4, the SMOKE
configs) every such sum is exact, so the port equals JAX bitwise; at
head_dim 32 (scale 2^-2.5) the two agree within ``L * hd * scale *
2^-23`` (fp32), plus one bf16 ulp of the largest context in bf16.

* the bundle's plain version (bn, and rope causal) against the Pallas
  ``fused_ssa(binarize_scores=False)`` in interpret mode, with its (H, 4)
  counts;
* the layer program's plain versions (fused and pipelined; bn tile,
  decoded, rope) against the jitted JAX ``reference_layer`` with an
  analog ``SpikingConfig``, with the counts of the TPU kernel's
  predicates (every score block live);
* ``spike_attention``'s plain analog context (#7) bitwise equal to the
  bundle's on the same q / k / v at head_dim 32, and the popcount mode
  and the oracle equal to both;
* the SMOKE 4-256 and 8-512 analog forwards and their prefill steps under
  every overlap, a SMOKE analog train step, and the int8 SMOKE LM's
  analog prefill, each against JAX;
* the analog variants run where they raised before.

The CUDA kernels' analog instantiations are held against these plain
versions on the card by ``chip_smoke.py``.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core.spiking import SpikingConfig as JSpikingConfig  # noqa: E402
from repro.kernels import fused_layer as JFL  # noqa: E402
from repro.kernels import fused_ssa as JFS  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.quant import quantize_tree as jquantize_tree  # noqa: E402
from repro.sim.balance_sim import binary_block_schedule  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.spiking import SpikingConfig, lif_scan  # noqa: E402
from repro_torch.kernels import fused_layer as TFL  # noqa: E402
from repro_torch.kernels import fused_ssa as TFS  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import spike_attention as TSA  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.nn import bn_affine  # noqa: E402
from repro_torch.quant import quantize_tree  # noqa: E402

from _torch_helpers import bn_rows, dyadic, layer_ops, lif_np  # noqa: E402
from _torch_helpers import to_torch  # noqa: E402
from test_torch_lm import rope_layer_ops  # noqa: E402
from test_torch_spikingformer import ARCHS, _setup  # noqa: E402
from test_torch_train import _check_train_step  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# bundle shapes (T, B, L, D, H, hd): head_dim 16, where every analog sum
# is exact, and head_dim 32 at a ragged L past one 32-key word
BUNDLE = {"hd16": (2, 3, 16, 32, 2, 16), "hd32": (2, 2, 40, 32, 2, 32)}
# layer shapes (t, b, l, d, heads, hd, ff, l_block): a ragged L against
# l_block at head_dim 8 (scale 2^-1.5), the SMOKE width (head_dim 16) and
# several L-blocks at T = 4
LAYER = {"odd": (2, 2, 13, 16, 2, 8, 24, 8),
         "smoke": (2, 2, 16, 64, 4, 16, 128, 16),
         "multi": (4, 2, 40, 32, 2, 16, 64, 16)}
VARIANTS = {"bn tile": ("bn", "tile"), "bn decoded": ("bn", "decoded"),
            "rope": ("rope", "tile")}


def analog(cfg):
    """A config (JAX's or the port's) with analog scores: the shipped
    spiking config with ``binarize_scores=False``."""
    return cfg.replace(spiking=dataclasses.replace(cfg.spiking,
                                                   binarize_scores=False))


def _context_tol(shape, dtype, want):
    """The stated tolerance against JAX for a bundle's context ``want``:
    exact at head_dim 16; at head_dim 32, ``L * hd * scale * 2^-23`` (two
    orders of one fp32 sum of at most L scores of at most hd * scale),
    and in bf16 one bf16 ulp of the largest context on top, ``2^-7 *
    max|want|`` (the two fp32 sums may round to neighbouring bf16
    values)."""
    _, _, l, _, _, hd = shape
    if hd == 16:
        return 0.0
    tol = l * hd * (1.0 / math.sqrt(hd)) * 2.0 ** -23
    if dtype == "bfloat16":
        tol += 2.0 ** -7 * float(np.abs(want).max())
    return tol


# --- the SSA bundle (#6, #6b) ----------------------------------------------


def _bundle_ops(seed, shape, family):
    """numpy operands: bn — LIF spikes of dyadic currents with a dark
    (t=0, b=0) slab, dyadic weights, BN rows; rope — dyadic normed
    currents with an all-zero token, dyadic weights, the port's table."""
    t, b, l, d, h, hd = shape
    rng = np.random.default_rng(seed)
    if family == "bn":
        x = lif_np((rng.integers(-64, 224, (t, b, l, d)) / 128.0
                    ).astype(np.float32))
        aux = np.stack([bn_rows(rng, h * hd) for _ in range(3)])
        w3 = dyadic(rng, (3, d, h * hd))
    else:
        from test_torch_lm import _table
        x = dyadic(rng, (t, b, l, d), bits=5) * 2
        x[:, :, min(2, l - 1)] = 0.0
        aux = _table(l, hd)
        w3 = dyadic(rng, (3, d, h * hd)) * 2
    x[0, 0] = 0.0
    return x, w3, aux


def _bundle_kw(shape, family):
    _, _, _, _, h, hd = shape
    return dict(family=family, num_heads=h, head_dim=hd,
                scale=1.0 / math.sqrt(hd), causal=family == "rope")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(BUNDLE))
@pytest.mark.parametrize("family", ["bn", "rope"])
def test_fused_ssa_analog_plain_matches_pallas(family, shape, dtype):
    """The analog bundle's plain version (what the wrapper runs on CPU
    tensors) against the interpret-mode Pallas kernel: the (H, 4) counts
    equal (q, k, v count the live slabs; attend 2 T), the context bitwise
    at head_dim 16 and within :func:`_context_tol` at head_dim 32; the
    port's oracle equals its plain version."""
    shape = BUNDLE[shape]
    x, w3, aux = _bundle_ops(1, shape, family)
    jd, td = DTYPES[dtype]
    kw = _bundle_kw(shape, family)
    want, wcnt = JFS.fused_ssa(jnp.asarray(x, jd), jnp.asarray(w3, jd), None,
                               jnp.asarray(aux), 0.3, binarize_scores=False,
                               **kw)
    tx, tw, taux = (torch.from_numpy(x).to(td), torch.from_numpy(w3).to(td),
                    torch.from_numpy(aux))
    before = dict(TFS.LAUNCHES)
    got, cnt = TFS.fused_ssa(tx, tw, None, taux, 0.3, binarize_scores=False,
                             **kw)
    assert TFS.LAUNCHES == before and got.dtype == td
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_context_tol(shape, dtype, want))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    t, b = shape[:2]
    assert cnt[0].tolist() == [t * b - 1] * 3 + [2 * t * b]
    assert np.abs(want).max() > 1.0          # scores well past one count
    ref = TFS.reference_bundle(tx, tw, None, taux, 0.3, SpikingConfig(
        time_steps=t, binarize_scores=False), **kw)
    assert torch.equal(got, ref)


def _bn_spikes(x, w3, aux, t):
    """The bn bundle's q / k / v spikes, as ``reference_bundle`` forms
    them (fp32 projection, cast, BN, LIF), folded to (T*B*H, L, hd)."""
    out = []
    for j in range(3):
        y = (x.float() @ w3[j].float()).to(x.dtype)
        y = bn_affine(y.float(), aux[j, 0], torch.rsqrt(aux[j, 1] + 1e-5),
                      aux[j, 2], aux[j, 3]).to(x.dtype)
        out.append(lif_scan(y, SpikingConfig(time_steps=t))[0])
    return out


def test_spike_attention_analog_context_equals_the_bundles():
    """At head_dim 32 (scale 2^-2.5, where the order of the sum shows)
    #7's plain analog context equals the bundle's plain context bitwise
    on the same q / k / v: both sum ``fl(count * scale)`` over the keys
    in ascending order. The popcount mode and the oracle (the 'jnp'
    mode) of ``binary_attention`` sum the same way."""
    shape = (2, 3, 64, 32, 2, 32)
    t, b, l, d, h, hd = shape
    x, w3, aux = (torch.from_numpy(a) for a in _bundle_ops(7, shape, "bn"))
    kw = _bundle_kw(shape, "bn")
    ctx, _ = TFS.fused_ssa(x, w3, None, aux, 0.3, binarize_scores=False,
                           **kw)
    q, k, v = (u.reshape(t * b, l, h, hd).transpose(1, 2).reshape(-1, l, hd)
               for u in _bn_spikes(x, w3, aux, t))
    bundle = ctx.reshape(t * b, l, h, hd).transpose(1, 2).reshape(-1, l, hd)
    akw = dict(scale=kw["scale"], delta=0.3, binarize_scores=False)
    got = TSA.spike_attention(q, k, v, **akw)
    assert torch.equal(got, bundle)
    assert torch.equal(TO.binary_attention(q, k, v, use_popcount=True, **akw),
                       bundle)
    assert torch.equal(TO.binary_attention_oracle(
        q, k, v, 0.3, alpha=4.0, scale=kw["scale"], causal=False,
        binarize_scores=False), bundle)
    exact = (TFS.analog_scores(q, k, kw["scale"]).double() @ v.double())
    assert float(bundle.double().sub(exact).abs().max()) < l * 2.0 ** -20
    assert float(bundle.abs().max()) > 1.0


# --- the layer program (#1, #1b, #1c, #1d) ---------------------------------


def _layer_args(variant, shape, seed=11):
    family, _ = VARIANTS[variant]
    t, b, l, d, heads, hd, ff, l_block = LAYER[shape]
    if family == "rope":
        return rope_layer_ops(seed, t, b, l, d, heads, hd, ff)
    args = list(layer_ops(seed, t, b, l, d, heads, hd, ff))
    if shape == "multi":                    # a dark L-block of batch row 1
        args[0][:, 1, :l_block] = 0.0
        args[1][:, 1, :l_block] = 0.0
    return tuple(args)


def _layer_kw(variant, shape):
    family, _ = VARIANTS[variant]
    _, _, _, _, heads, hd, _, _ = LAYER[shape]
    return dict(family=family, num_heads=heads, head_dim=hd,
                scale=1.0 / math.sqrt(hd), causal=family == "rope")


@pytest.mark.parametrize("shape", list(LAYER))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_layer_analog_plain_against_jitted_jax_oracle(variant, shape):
    """The analog layer program's plain versions, fused and pipelined,
    against the jitted JAX ``reference_layer`` under an analog
    ``SpikingConfig`` (JAX's kernel cannot run under the installed jax;
    its own tests pin it to that oracle). Tolerances: bn at head_dim 16
    bitwise (exact sums); at head_dim 8 (scale 2^-1.5) 1e-5, the context
    and wo sums in another order than XLA's; rope 1e-5, the LM tests'
    rsqrt gap of ln2. The pipelined version equals the fused one
    bitwise, outputs and counts; no launch on CPU tensors."""
    family, sparse = VARIANTS[variant]
    t, b, l, d, heads, hd, ff, l_block = LAYER[shape]
    args = _layer_args(variant, shape)
    kw = _layer_kw(variant, shape)
    scfg = JSpikingConfig(time_steps=t, binarize_scores=False)
    want = np.asarray(jax.jit(lambda *a: JFL.reference_layer(
        *a, scfg, **kw))(*args))
    assert np.isfinite(want).all() and want.std() > 0
    before = dict(TFL.LAUNCHES)
    out, cnt = TFL.fused_layer(*to_torch(args), l_block=l_block,
                               sparse=sparse, binarize_scores=False, **kw)
    pout, pcnt = TFL.fused_layer(*to_torch(args), l_block=l_block,
                                 sparse=sparse, pipeline=True,
                                 binarize_scores=False, **kw)
    assert TFL.LAUNCHES == before
    assert torch.equal(out, pout) and torch.equal(cnt, pcnt)
    tol = 0.0 if family == "bn" and hd == 16 else 1e-5
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=tol)
    ref = TFL.reference_layer(*to_torch(args), SpikingConfig(
        time_steps=t, binarize_scores=False), **kw)
    np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=tol)
    # the binarized layer on the same operands is another function
    bin_out, bin_cnt = TFL.fused_layer(*to_torch(args), l_block=l_block,
                                       sparse=sparse, **kw)
    assert not torch.equal(bin_out, out)
    assert cnt.shape == bin_cnt.shape == (heads, 8, -(-l // l_block))


@pytest.mark.parametrize("variant", ["bn tile", "rope"])
def test_layer_analog_counts_follow_the_kernel_predicates(variant):
    """Analog scores keep every score block live (JAX's ``_qkt_live``:
    ``live | True``): qkt counts every (t, b) of every L-block, and a
    context block runs when its value rows are not all dark — the numpy
    twin ``binary_block_schedule(binarize=False)`` fed the port's own
    k / v spikes; the other phases count as with binarized scores."""
    shape = "multi"
    family, sparse = VARIANTS[variant]
    t, b, l, d, heads, hd, ff, l_block = LAYER[shape]
    args = to_torch(_layer_args(variant, shape, seed=13))
    kw = _layer_kw(variant, shape)
    seen = {}
    real = TFL._layer_plain

    def spy(*a, lif, **k):
        def keep(name, u):
            seen[name] = lif(name, u)
            return seen[name]
        return real(*a, lif=keep, **k)
    TFL._layer_plain = spy
    try:
        _, cnt = TFL.fused_layer(*args, l_block=l_block, sparse=sparse,
                                 binarize_scores=False, **kw)
    finally:
        TFL._layer_plain = real
    _, bin_cnt = TFL.fused_layer(*args, l_block=l_block, sparse=sparse, **kw)
    nlb = -(-l // l_block)
    np.testing.assert_array_equal(cnt[:, 3].numpy(),
                                  np.full((heads, nlb), t * b))
    pred = binary_block_schedule(seen["k"].numpy(), seen["v"].numpy(), heads,
                                 l_block, 0.3, binarize=False)
    np.testing.assert_array_equal(cnt[:, 3:5].numpy(), pred)
    np.testing.assert_array_equal(cnt[:, :3].numpy(), bin_cnt[:, :3].numpy())
    assert (cnt[:, 3] >= bin_cnt[:, 3]).all()


def test_analog_variants_run_where_they_raised():
    """``_check_bundle`` and ``_check_variant`` take analog scores now:
    the bundle and every layer program variant run their plain version
    on CPU tensors (no launch); the CUDA launchers still check their
    operands before anything is built."""
    shape = BUNDLE["hd16"]
    x, w3, aux = (torch.from_numpy(a) for a in _bundle_ops(2, shape, "bn"))
    for family in ("bn", "rope"):
        if family == "rope":
            x, w3, aux = (torch.from_numpy(a)
                          for a in _bundle_ops(2, shape, "rope"))
        TFS._check_bundle(x, w3, None, aux, family, shape[4], shape[5])
        ctx, cnt = TFS.fused_ssa(x, w3, None, aux, 0.3,
                                 binarize_scores=False,
                                 **_bundle_kw(shape, family))
        assert ctx.shape == (*shape[:3], shape[4] * shape[5])
        assert float(ctx.abs().sum()) > 0
    before = dict(TFL.LAUNCHES)
    for variant in VARIANTS:
        family, sparse = VARIANTS[variant]
        TFL._check_variant(family, sparse)
        for pipeline in (False, True):
            out, _ = TFL.fused_layer(*to_torch(_layer_args(variant, "odd")),
                                     l_block=8, sparse=sparse,
                                     pipeline=pipeline,
                                     binarize_scores=False,
                                     **_layer_kw(variant, "odd"))
            assert torch.isfinite(out).all()
    assert TFL.LAUNCHES == before
    assert {n for n in TFL.LAUNCHES if n.endswith("_analog")} == {
        f"fused_layer{s}{v}_analog" for s in ("", "_pipeline")
        for v in ("", "_decoded", "_rope")}
    with pytest.raises(ValueError, match="fused_ssa kernel takes"):
        TFS.fused_ssa_cuda(x.bfloat16(), w3, None, aux, 0.3,
                           binarize_scores=False,
                           **_bundle_kw(shape, "rope"))
    assert TFS.LAUNCHES["fused_ssa_rope_analog"] == 0


# --- whole models ----------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_vision_analog_forward_against_jax(arch):
    """The SMOKE model with analog scores (its layers take the sequential
    composition; under 'fused' / 'pipeline' / 'auto' on the card the
    bundle #6): ``registry.forward`` under every overlap and sparse
    datapath bitwise equal to the jitted JAX forward (head_dim 16: exact
    sums), the bundle's plain version run once a layer under 'fused' and
    'pipeline'; ``build_prefill_step`` (init BN state) under every
    overlap equal to each other bitwise and to JAX's prefill step within
    1e-5, the rsqrt(1 + eps) ulp of ``test_torch_spikingformer``."""
    cfg, tcfg, params, state, batch = _setup(arch)
    cfg, tcfg = analog(cfg), analog(tcfg)
    with JE.use_engine(cfg.engine.replace(overlap="off")):
        want = np.asarray(jax.jit(
            lambda p, b, s: JR.forward(p, cfg, b, state=s)[0])(
                params, batch, state))
    assert np.isfinite(want).all() and want.std() > 0
    tp, ts, tb = (interop.to_torch(a, device="cpu")
                  for a in (params, state, batch))
    calls = []
    real = TFS.fused_ssa_plain

    def spy(*a, **kw):
        calls.append(kw["binarize_scores"])
        return real(*a, **kw)
    TFS.fused_ssa_plain = spy
    try:
        for overlap, sparse in (("off", "tile"), ("fused", "tile"),
                                ("fused", "decoded"), ("pipeline", "tile"),
                                ("auto", "auto")):
            with TE.use_engine(tcfg.engine.replace(overlap=overlap,
                                                   sparse=sparse)):
                logits, aux = TR.forward(tp, tcfg, tb, state=ts)
            np.testing.assert_array_equal(logits.numpy(), want,
                                          err_msg=f"{overlap} {sparse}")
            assert 0 < float(aux["fire_rate"]) < 1
    finally:
        TFS.fused_ssa_plain = real
    assert calls == [False] * (3 * tcfg.num_layers)
    jwant = np.asarray(jsteps.build_prefill_step(cfg)(params, batch))
    got = {ov: steps.build_prefill_step(tcfg.replace(
        engine=tcfg.engine.replace(overlap=ov)), device="cpu")(tp, tb)
        for ov in ("off", "fused", "pipeline", "auto")}
    for ov, logits in got.items():
        assert torch.equal(logits, got["off"]), ov
    np.testing.assert_allclose(got["fused"].numpy(), jwant, rtol=0,
                               atol=1e-5)


def test_smoke_analog_train_step_against_the_jitted_jax_train_step():
    """One SMOKE 4-256 train step with analog scores (the sequential
    composition; binary attention's 'mxu_kernel' mode, whose plain
    version sums the analog context in ascending key order) against the
    jitted JAX step, with ``test_torch_train``'s tolerances: no spike
    flips, loss and fire rate bitwise, gradients 1e-4 of each leaf's
    scale, params 5e-5, BN state 1e-5; every param moves."""
    _check_train_step(spiking=dict(binarize_scores=False))


def test_int8_smoke_lm_analog_prefill_against_jax():
    """The int8 SMOKE LM with analog scores: the rope layer program is
    ineligible, so every layer runs ``ssa_step_causal``'s bundle (#6b,
    causal, analog) under 'fused', 'pipeline' and 'auto' on the card,
    and the sequential composition under 'off'. Against JAX's prefill
    step on JAX's int8 tree within 1e-5 (the LM tests' tolerance: ln1's
    rsqrt gap); 'pipeline' equals 'fused' bitwise."""
    jcfg = analog(jget_config("spikingformer-lm", smoke=True))
    cfg = analog(get_config("spikingformer-lm", smoke=True))
    jp = jax.tree_util.tree_map(np.asarray,
                                JR.init(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = np.asarray(jax.jit(jsteps.build_prefill_step(jcfg))(
        jquantize_tree(jp, "int8"), {"tokens": toks}))
    tq = quantize_tree(interop.to_torch(jp, device="cpu"), "int8")
    calls = []
    real = TFS.fused_ssa_plain

    def spy(*a, **kw):
        calls.append((kw["family"], kw["binarize_scores"]))
        return real(*a, **kw)
    TFS.fused_ssa_plain = spy
    try:
        got = {ov: steps.build_prefill_step(cfg.replace(
            engine=cfg.engine.replace(overlap=ov, weights="int8")),
            device="cpu")(tq, {"tokens": torch.from_numpy(toks)})
            for ov in ("off", "fused", "pipeline")}
    finally:
        TFS.fused_ssa_plain = real
    assert calls == [("rope", False)] * (2 * cfg.num_layers)
    assert want.std() > 0
    for ov, logits in got.items():
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=ov)
    assert torch.equal(got["pipeline"], got["fused"])


@pytest.mark.parametrize("arch", ["spikingformer-4-256", "spikingformer-lm"])
def test_analog_bundle_gradients_equal_off(arch, monkeypatch):
    """``_FusedBundle``'s backward recomputes ``reference_bundle`` with
    analog scores: an eval-mode forward of the SMOKE model with analog
    scores under 'fused' — the bundle (bn; rope, causal, for the fp32
    LM) through a launcher whose output is detached, as the CUDA
    launcher's is — gives the logits and every layer parameter the
    gradient they get under 'off' (the sequential composition), bitwise."""
    from test_torch_grads import _grads, _model, _paths
    family = "rope" if arch == "spikingformer-lm" else "bn"
    cfg, params, kw, batch = _model(family)
    cfg = analog(cfg)
    calls = []
    real = TFS.fused_ssa

    def launcher(*args, **k):
        ctx, counts = real(*args, **k)
        calls.append((k["family"], k["binarize_scores"]))
        return ctx.detach().clone(), counts
    monkeypatch.setattr(TFS, "fused_ssa", launcher)
    fused, g_fused = _grads(cfg, params, kw, batch, "fused")
    assert calls == [(family, False)] * cfg.num_layers
    off, g_off = _grads(cfg, params, kw, batch, "off")
    assert len(calls) == cfg.num_layers
    assert torch.equal(fused, off) and float(fused.std()) > 0
    names = _paths(params["blocks" if family == "bn" else "layers"])
    # analog scores do not read the threshold delta: no gradient, either way
    assert [n for n, g in zip(names, g_fused) if g is None] == ["delta"]
    for a, b in zip(g_fused, g_off):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    flat = dict(zip(names, g_fused))
    for name in ("wq/w", "wk/w", "wv/w", "wo/w"):
        assert float(flat[name].abs().sum()) > 0, name
