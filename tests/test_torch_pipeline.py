"""The layer program's pipelined schedule (``overlap='pipeline'``, the TPU
kernel's timestep wavefront) in the port, against the port's fused
schedule and the JAX package.

* ``fused_layer_pipeline_plain`` (one timestep at a time, each membrane
  carried to the next timestep, each timestep's executed sub-blocks
  added) equals ``fused_layer_plain`` bitwise in outputs and counts: bn
  tile, bn decoded and rope, fp32 and bf16, odd, SMOKE, multi-block and
  T = 6 shapes;
* it equals the jitted JAX ``reference_layer`` bitwise on dyadic
  weights (bn), and within the rope tests' stated 1e-5 (rope). JAX's
  pipeline kernel itself is not run: under the installed jax (0.9) its
  ``pl.store`` is missing and the kernel cannot trace, in interpret mode
  too (ROADMAP queue 3); its docstring and its own tests pin its outputs
  and counts to the fused grid's, and those to ``reference_layer``;
* the SMOKE Spikingformer-4-256 and 8-512 forwards under 'pipeline'
  equal JAX's ``overlap='off'`` forward bitwise (the fused tests'
  tolerance), the int8 LM prefill within 1e-5 (the LM tests' tolerance);
  the mixed trees under 'pipeline' run the bundle kernel as under
  'fused', with the same logits;
* the CUDA launcher's pipelined shape checks (one timestep's layout, no
  bound on T) raise before anything is built.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core.spiking import SpikingConfig as JSpikingConfig  # noqa: E402
from repro.kernels import fused_layer as JFL  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.quant import quantize_tree as jquantize_tree  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.kernels import fused_layer as TFL  # noqa: E402
from repro_torch.kernels import fused_ssa as TFS  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.quant import quantize_tree  # noqa: E402

from _torch_helpers import layer_ops, to_torch  # noqa: E402
from test_torch_lm import rope_layer_ops  # noqa: E402
from test_torch_spikingformer import ARCHS, _setup  # noqa: E402

# (t, b, l, d, heads, hd, ff, l_block): a ragged L against l_block with
# d_ff not a multiple of heads (bn pads it), the SMOKE width, several
# L-blocks with one dark, and T = 6 (two of launch B's groups of timesteps)
SHAPES = {"odd": (2, 2, 13, 16, 2, 8, 21, 8),
          "smoke": (2, 2, 16, 64, 4, 16, 128, 16),
          "multi": (4, 2, 40, 32, 2, 16, 64, 16),
          "t6": (6, 2, 13, 16, 2, 8, 24, 8)}
VARIANTS = {"bn tile": ("bn", "tile"), "bn decoded": ("bn", "decoded"),
            "rope": ("rope", "tile")}


def _kw(family, heads, hd):
    return dict(family=family, num_heads=heads, head_dim=hd,
                scale=1.0 / math.sqrt(hd), causal=family == "rope")


def _operands(variant, shape, dtype, seed=5):
    """(prepared args, kwargs) of one layer call: dyadic operands, the
    activations and weights in ``dtype``; for 'multi' the first L-block
    of batch row 1 dark at every t."""
    family, sparse = VARIANTS[variant]
    t, b, l, d, heads, hd, ff, l_block = SHAPES[shape]
    make = rope_layer_ops if family == "rope" else layer_ops
    if family == "rope":
        ff += -ff % heads
    ops = list(to_torch(make(seed, t, b, l, d, heads, hd, ff)))
    if shape == "multi":
        ops[0][:, 1, :l_block] = 0.0
        ops[1][:, 1, :l_block] = 0.0
    ops[:6] = [a.to(dtype) for a in ops[:6]]
    kw = _kw(family, heads, hd)
    return TFL.prepare(*ops, decay=0.5, v_th=1.0, soft_reset=False,
                       eps=1e-5, l_block=l_block, sparse=sparse, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_pipeline_plain_equals_fused_plain(variant, shape, dtype):
    args, kw = _operands(variant, shape, dtype)
    out_p, cnt_p = TFL.fused_layer_pipeline_plain(*args, **kw)
    out_f, cnt_f = TFL.fused_layer_plain(*args, **kw)
    assert out_p.dtype == dtype and cnt_p.dtype == torch.int32
    assert torch.equal(out_p, out_f)
    assert torch.equal(cnt_p, cnt_f)
    assert float(out_f.float().std()) > 0 and int(cnt_f.sum()) > 0
    if shape == "multi":            # the dark L-block is skipped
        assert (cnt_f[:, :3, 0] < cnt_f[:, :3, 1]).all()


def test_pipeline_carries_the_membranes():
    """A layer whose timesteps are run as separate T = 1 calls (each
    membrane starting at zero) differs from the pipelined call: the
    carry across T is what makes it equal the fused schedule."""
    args, kw = _operands("bn tile", "smoke", torch.float32)
    out, _ = TFL.fused_layer_pipeline_plain(*args, **kw)
    alone = torch.cat([TFL.fused_layer_pipeline_plain(
        args[0][t:t + 1], args[1][t:t + 1], *args[2:], **kw)[0]
        for t in range(args[0].shape[0])])
    assert torch.equal(out[:1], alone[:1])
    assert not torch.equal(out, alone)


@pytest.mark.parametrize("scales", [False, True])
@pytest.mark.parametrize("shape", ["odd", "smoke", "t6"])
def test_pipeline_bitwise_against_jitted_jax_oracle(shape, scales):
    """bn family on dyadic weights: the wrapper's pipelined plain path,
    tile and decoded, equals the jitted JAX ``reference_layer``."""
    t, b, l, d, heads, hd, ff, l_block = SHAPES[shape]
    args = layer_ops(11, t, b, l, d, heads, hd, ff, scales=scales)
    kw = _kw("bn", heads, hd)
    scfg = JSpikingConfig(time_steps=t)
    want = np.asarray(jax.jit(lambda *a: JFL.reference_layer(
        *a, scfg, **kw))(*args))
    assert np.isfinite(want).all() and want.std() > 0
    before = dict(TFL.LAUNCHES)
    for sparse in ("tile", "decoded"):
        out, cnt = TFL.fused_layer(*to_torch(args), l_block=l_block,
                                   sparse=sparse, pipeline=True, **kw)
        np.testing.assert_array_equal(out.numpy(), want, err_msg=sparse)
        assert cnt.shape == (heads, 8, -(-l // l_block))
    assert TFL.LAUNCHES == before           # CPU: no launch


@pytest.mark.parametrize("shape", ["odd", "t6"])
def test_pipeline_rope_against_jitted_jax_oracle(shape):
    """The rope family (causal) pipelined against the jitted JAX
    ``reference_layer``: within 1e-5, the rope tests' tolerance (ln2's
    rsqrt and the up projection's sum order)."""
    t, b, l, d, heads, hd, ff, l_block = SHAPES[shape]
    ff += -ff % heads
    args = rope_layer_ops(7, t, b, l, d, heads, hd, ff)
    kw = _kw("rope", heads, hd)
    scfg = JSpikingConfig(time_steps=t)
    want = np.asarray(jax.jit(lambda *a: JFL.reference_layer(
        *a, scfg, **kw))(*args))
    out, _ = TFL.fused_layer(*to_torch(args), l_block=l_block,
                             pipeline=True, **kw)
    assert np.isfinite(want).all() and want.std() > 0
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_vision_forward_under_pipeline_bitwise_against_jax(arch):
    """The SMOKE vision forward under overlap='pipeline' (tile and
    decoded; the layer program's pipelined plain version in every layer)
    equals the jitted JAX forward under overlap='off', bitwise, as the
    fused forward does (``test_torch_spikingformer``)."""
    cfg, tcfg, params, state, batch = _setup(arch)
    with JE.use_engine(cfg.engine.replace(overlap="off")):
        want = np.asarray(jax.jit(
            lambda p, b, s: JR.forward(p, cfg, b, state=s)[0])(
                params, batch, state))
    assert np.isfinite(want).all() and want.std() > 0
    tp, ts, tb = (interop.to_torch(a, device="cpu")
                  for a in (params, state, batch))
    calls = []
    real = TFL.fused_layer_pipeline_plain

    def spy(*a, **kw):
        calls.append(kw["decoded"])
        return real(*a, **kw)
    TFL.fused_layer_pipeline_plain = spy
    try:
        for sparse in ("tile", "decoded"):
            with E.use_engine(tcfg.engine.replace(overlap="pipeline",
                                                  sparse=sparse)):
                logits, aux = TR.forward(tp, tcfg, tb, state=ts)
            np.testing.assert_array_equal(logits.numpy(), want,
                                          err_msg=sparse)
            assert 0 < float(aux["fire_rate"]) < 1
    finally:
        TFL.fused_layer_pipeline_plain = real
    assert calls == [False] * tcfg.num_layers + [True] * tcfg.num_layers


def test_int8_lm_prefill_under_pipeline_against_jax():
    """The SMOKE int8 LM prefill under overlap='pipeline' against JAX's
    prefill step on JAX's int8 tree (whose eligible layers run the
    oracle): within 1e-5, the LM tests' tolerance; equal to the port's
    'fused' prefill bitwise."""
    jcfg = jget_config("spikingformer-lm", smoke=True)
    cfg = get_config("spikingformer-lm", smoke=True)
    jp = jax.tree_util.tree_map(np.asarray,
                                JR.init(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(jax.jit(jsteps.build_prefill_step(jcfg))(
        jquantize_tree(jp, "int8"), {"tokens": toks}))
    tq = quantize_tree(interop.to_torch(jp, device="cpu"), "int8")
    got = {ov: steps.build_prefill_step(cfg.replace(
        engine=cfg.engine.replace(overlap=ov, weights="int8")),
        device="cpu")(tq, {"tokens": torch.from_numpy(toks)})
        for ov in ("pipeline", "fused")}
    assert want.std() > 0
    np.testing.assert_allclose(got["pipeline"].numpy(), want, rtol=0,
                               atol=1e-5)
    assert torch.equal(got["pipeline"], got["fused"])


def _select_mixed(path):
    return path.rsplit("/", 1)[-1] not in ("wq", "wk", "wv")


def _select_qkv(path):
    return path.rsplit("/", 1)[-1] in ("wq", "wk", "wv")


@pytest.mark.parametrize("arch", ["spikingformer-4-256", "spikingformer-lm"])
def test_mixed_trees_under_pipeline_run_the_bundle_as_fused(arch,
                                                            monkeypatch):
    """The mixed int8 trees (vision: int8 wo, w1, w2, head; LM: int8 wq,
    wk, wv) are not eligible for the layer program; under 'pipeline', as
    in JAX, their bundles run ``fused_ssa`` (the plain version here), one
    call a layer, and the logits equal those under 'fused' bitwise."""
    cfg = get_config(arch, smoke=True)
    vision = arch != "spikingformer-lm"
    params = TR.init(cfg, 0, device="cpu")
    if vision:                  # BN biases raised so the layers fire
        for bn in [p["bn"] for p in params["sps"]] + [
                v for k, v in params["blocks"].items() if k.startswith("bn_")]:
            bn["bias"] = bn["bias"] + 0.25
    params = quantize_tree(params, "int8",
                           select=_select_mixed if vision else _select_qkv)
    rng = np.random.default_rng(2)
    if vision:
        v = cfg.vision
        batch = {"images": torch.from_numpy(rng.random(
            (2, v.img_size, v.img_size, v.in_channels)).astype(np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32))}
    calls = []
    real = TFS.fused_ssa

    def spy(*a, **kw):
        calls.append(kw["family"])
        return real(*a, **kw)
    monkeypatch.setattr(TFS, "fused_ssa", spy)
    got = {}
    for ov in ("pipeline", "fused"):
        with E.use_engine(cfg.engine.replace(overlap=ov)):
            got[ov], _ = TR.forward(params, cfg, batch)
    family = "bn" if vision else "rope"
    assert calls == [family] * (2 * cfg.num_layers)
    assert torch.equal(got["pipeline"], got["fused"])
    assert float(got["fused"].std()) > 0


@pytest.mark.parametrize("elem_size", [2, 4])
def test_pipeline_launch_bounds(elem_size):
    """The pipelined kernel and the fused one take the same shapes:
    launch B holds groups of timesteps, so any T (T = 4, 6 and 64 pass,
    as for the fused kernel), and launch A, whose spike bits live in
    device memory, takes any L: the LM's rope layer (D = 256, 8 heads of
    32) past the old one-timestep bound (15008 tokens in bf16, 11328 in
    fp32) and 8-512's layer at L 40000. head_dim 136 is refused; F has no
    bound (launch B's spike bits are sized by ``spike_words``, here F / H
    = 36, off the earlier grid of 8)."""
    shape = (196, 512, 8, 64, 2)
    for t in (4, 6, 64):
        TFL.check_launch_shapes(elem_size, t, *shape)
    for l in (15009, 11329, 40000):
        TFL.check_launch_shapes(elem_size, 4, l, 256, 8, 32, -(-l // 128),
                                rope=True)
    TFL.check_launch_shapes(elem_size, 6, 40000, 512, 8, 64, 313)
    with pytest.raises(ValueError, match="head_dim"):
        TFL.check_launch_shapes(elem_size, 6, 196, 512, 8, 136, 2)
    TFL.check_launch_shapes(elem_size, 6, 196, 512, 8, 64, 2)
    assert TFL.spike_words(1, 32 * 196, 512, 8 * 36) > 0


@pytest.mark.parametrize("bad", ["odd_head_dim", "half", "mixed", "head_dim"])
def test_pipeline_launcher_rejects_operands_before_launching(bad):
    """The pipelined CUDA launcher checks shapes and dtypes before it
    builds or calls the kernel, so these raise here too, at T = 6:
    head_dim 12 (not a multiple of 8) and 136 (past four words a row)."""
    t, l = 6, 13
    heads, d, ff = 2, 16, 16
    hd = {"odd_head_dim": 12, "head_dim": 136}.get(bad, 8)
    args, kw = TFL.prepare(*to_torch(layer_ops(7, t, 1, l, d, heads, hd, ff)),
                           num_heads=heads, head_dim=hd,
                           scale=1.0 / math.sqrt(hd), decay=0.5, v_th=1.0,
                           soft_reset=False, eps=1e-5, l_block=8)
    if bad == "half":
        args = (args[0].half(), args[1].half()) + args[2:]
    if bad == "mixed":
        args = args[:2] + (args[2].double(),) + args[3:]
    before = dict(TFL.LAUNCHES)
    with pytest.raises(ValueError):
        TFL.fused_layer_pipeline_cuda(*args, **kw)
    assert TFL.LAUNCHES == before
