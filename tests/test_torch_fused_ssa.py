"""The port's SSA bundle kernel and the mixed-precision int8 vision slice
against the JAX package.

* ``fused_ssa`` on CPU tensors (its plain version) equals JAX
  ``fused_ssa`` (the Pallas kernel in interpret mode), bn family:
  context and the ``(H, 4)`` count map bitwise, fp weights and int8
  codes with ``scale3``, fp32 and bf16, L a multiple of 8 and L = 13,
  an all-zero input (q / k / v counts 0); and equals the port's
  ``reference_bundle``; the rope family (#6b, causal) likewise on a
  shared RoPE table and dyadic currents (exact projection sums, so the
  kernel's ascending-k order and XLA's dot agree bitwise);
* ``ssa_step`` with ``overlap='fused'`` (the bundle through the plain
  version) equals JAX's ``ssa_step`` under explicit ``overlap='fused'``
  bitwise and returns the BN state unchanged; its gradients recompute
  through the oracle and equal the sequential composition's;
* the slice: the SMOKE Spikingformer-4-256 with a mixed PTQ tree (int8
  ``wo``, ``w1``, ``w2`` and head, fp ``wq``, ``wk``, ``wv``; dyadic
  scales; weights that fire) through the port's ``registry.forward``
  with ``overlap='fused'``, ``mode='sparse'`` and either datapath equals
  JAX's ``registry.forward`` under the same engine (tile) and JAX's
  sequential oracle (``overlap='off'``, ``mode='dense'``, bitwise equal
  on dyadic weights, DESIGN.md §4), logits bitwise; the complementary
  tree (int8 ``wq``, ``wk``, ``wv``) and an int4 mixed tree likewise;
  ``interop.to_torch`` carries the mixed tree leaf for leaf.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.kernels import fused_ssa as JF  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.quant import quantize as JQ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.spiking import SpikingConfig  # noqa: E402
from repro_torch.kernels import fused_ssa as TF  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

from _torch_helpers import bn_rows, dyadic, lif_np  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# T, B, L, D, H, hd
SHAPES = {"l16": (2, 3, 16, 32, 2, 8), "l13": (2, 2, 13, 32, 2, 16)}
ARCH = "spikingformer-4-256"


def _bundle_ops(seed, shape, quant, zero=False):
    """numpy bundle operands: LIF spikes of dyadic currents with a dark
    (t=0, b=0) slab, dyadic weights or int8 codes with dyadic-ish
    scales, BN rows with agreeing variances."""
    t, b, l, d, h, hd = shape
    rng = np.random.default_rng(seed)
    x = lif_np((rng.integers(-64, 224, (t, b, l, d)) / 128.0
                ).astype(np.float32))
    x[0, 0] = 0.0
    if zero:
        x[:] = 0.0
    if quant:
        w3 = rng.integers(-127, 128, (3, d, h * hd)).astype(np.float32)
        scale3 = rng.uniform(2e-3, 2e-2, (3, h * hd)).astype(np.float32)
    else:
        w3, scale3 = dyadic(rng, (3, d, h * hd)), None
    aux = np.stack([bn_rows(rng, h * hd) for _ in range(3)])
    return x, w3, scale3, aux


def _kw(shape):
    _, _, _, _, h, hd = shape
    return dict(family="bn", num_heads=h, head_dim=hd,
                scale=1.0 / math.sqrt(hd))


def _rope_table(l, hd):
    """The port's RoPE table (cos, sin) as numpy, shared by both packages."""
    from repro_torch.models.nn import rope_table
    cos, sin = rope_table(torch.arange(l), hd, 10000.0)
    return cos.numpy(), sin.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("shape", ["l16", "l13"])
def test_fused_ssa_plain_matches_pallas(dtype, quant, shape):
    shape = SHAPES[shape]
    x, w3, scale3, aux = _bundle_ops(1, shape, quant)
    jd, td = DTYPES[dtype]
    want, wcnt = JF.fused_ssa(jnp.asarray(x, jd), jnp.asarray(w3, jd),
                              None if scale3 is None else jnp.asarray(scale3),
                              jnp.asarray(aux), 0.3, **_kw(shape))
    tx = torch.from_numpy(x).to(td)
    tw = torch.from_numpy(w3).to(td)
    tsc = None if scale3 is None else torch.from_numpy(scale3)
    got, cnt = TF.fused_ssa(tx, tw, tsc, torch.from_numpy(aux), 0.3,
                            **_kw(shape))
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    t, b = shape[:2]
    assert cnt[0, :3].tolist() == [t * b - 1] * 3     # one dark slab
    assert cnt[:, 3].tolist() == [2 * t * b] * shape[4]
    assert float(got.float().sum()) > 0
    ref = TF.reference_bundle(tx, tw, tsc, torch.from_numpy(aux), 0.3,
                              SpikingConfig(time_steps=shape[0]),
                              **_kw(shape))
    assert torch.equal(got, ref)


def test_fused_ssa_all_zero_input_and_checks():
    shape = SHAPES["l13"]
    x, w3, _, aux = _bundle_ops(2, shape, False, zero=True)
    want, wcnt = JF.fused_ssa(jnp.asarray(x), jnp.asarray(w3), None,
                              jnp.asarray(aux), 0.3, **_kw(shape))
    got, cnt = TF.fused_ssa(torch.from_numpy(x), torch.from_numpy(w3), None,
                            torch.from_numpy(aux), 0.3, **_kw(shape))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    assert cnt[:, :3].sum() == 0
    args = (torch.from_numpy(x), torch.from_numpy(w3), None,
            torch.from_numpy(aux), 0.3)
    # the rope family is ported: on the all-zero input it runs, equal to
    # the Pallas kernel, with no projection counted
    t, b, l, d, h, hd = shape
    table = np.stack(_rope_table(l, hd))
    rope_kw = dict(_kw(shape), family="rope", causal=True)
    want, wcnt = JF.fused_ssa(jnp.asarray(x), jnp.asarray(w3), None,
                              jnp.asarray(table), 0.3, **rope_kw)
    got, cnt = TF.fused_ssa(args[0], args[1], None, torch.from_numpy(table),
                            0.3, **rope_kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    assert cnt[:, :3].sum() == 0
    with pytest.raises(ValueError, match="w3 has shape"):
        TF.fused_ssa(args[0], args[1][:, :5], *args[2:], **_kw(shape))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        TF.fused_ssa(args[0].to("meta"), *args[1:], **_kw(shape))


@pytest.mark.parametrize("case", ["dtype", "head_dim", "wide_head", "d"])
def test_fused_ssa_launcher_rejects_operands_before_launching(case):
    """The CUDA launcher checks what launch A takes (one dtype, head_dim a
    multiple of 8 up to 128, D a multiple of 16; any L) and raises before
    it builds or launches anything; these operands lie on the CPU, where
    no kernel exists."""
    shape = {"head_dim": (2, 2, 16, 32, 2, 12),
             "wide_head": (2, 1, 16, 32, 1, 136),
             "d": (2, 2, 16, 40, 2, 8)}.get(case, SHAPES["l16"])
    t, b, l, d, h, hd = shape
    x = torch.zeros((t, b, l, d))
    wdt = torch.bfloat16 if case == "dtype" else torch.float32
    w3 = torch.zeros((3, d, h * hd), dtype=wdt)
    aux = torch.ones((3, 4, h * hd))
    with pytest.raises(ValueError, match="fused_ssa kernel takes"):
        TF.fused_ssa_cuda(x, w3, None, aux, 0.3, num_heads=h, head_dim=hd,
                          scale=1.0 / math.sqrt(hd))
    assert TF.LAUNCHES["fused_ssa"] == 0


def _rope_ops(seed, shape, quant):
    """numpy rope-bundle operands: dyadic normed currents (a dark (t=0,
    b=0) slab, an all-zero token) so every projection sum is exact in
    any order; dyadic weights or int8 codes with random scales; the
    port's table."""
    t, b, l, d, h, hd = shape
    rng = np.random.default_rng(seed)
    x = dyadic(rng, (t, b, l, d), bits=5) * 2
    x[:, :, min(2, l - 1)] = 0.0
    x[0, 0] = 0.0
    if quant:
        w3 = rng.integers(-127, 128, (3, d, h * hd)).astype(np.float32)
        scale3 = rng.uniform(2e-3, 2e-2, (3, h * hd)).astype(np.float32)
    else:
        w3, scale3 = dyadic(rng, (3, d, h * hd)) * 2, None
    return x, w3, scale3, np.stack(_rope_table(l, hd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("shape", ["l16", "l13"])
def test_fused_ssa_rope_plain_matches_pallas(dtype, quant, shape):
    """#6b: the rope family's plain version (causal) against the Pallas
    kernel in interpret mode on a shared table: context and (H, 4)
    counts bitwise (exact projection sums), and the port's oracle."""
    shape = SHAPES[shape]
    x, w3, scale3, table = _rope_ops(5, shape, quant)
    jd, td = DTYPES[dtype]
    kw = dict(_kw(shape), family="rope", causal=True)
    want, wcnt = JF.fused_ssa(jnp.asarray(x, jd), jnp.asarray(w3, jd),
                              None if scale3 is None else jnp.asarray(scale3),
                              jnp.asarray(table), 0.3, **kw)
    tx, tw = torch.from_numpy(x).to(td), torch.from_numpy(w3).to(td)
    tsc = None if scale3 is None else torch.from_numpy(scale3)
    before = dict(TF.LAUNCHES)
    got, cnt = TF.fused_ssa(tx, tw, tsc, torch.from_numpy(table), 0.3, **kw)
    assert TF.LAUNCHES == before and got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    t, b = shape[:2]
    assert cnt[0].tolist() == [t * b - 1] * 3 + [2 * t * b]
    assert float(got.float().sum()) > 0
    ref = TF.reference_bundle(tx, tw, tsc, torch.from_numpy(table), 0.3,
                              SpikingConfig(time_steps=shape[0]), **kw)
    assert torch.equal(got, ref)


def test_fused_ssa_rope_checks_its_operands():
    """The rope family takes the (2, L, hd/2) table as aux and an even
    head_dim; its launcher checks the shapes launch A takes (head_dim up
    to 128, any L) before it builds or launches anything (these operands
    lie on the CPU)."""
    shape = SHAPES["l13"]
    t, b, l, d, h, hd = shape
    x, w3, _, table = _rope_ops(6, shape, False)
    kw = dict(_kw(shape), family="rope", causal=True)
    args = (torch.from_numpy(x), torch.from_numpy(w3), None)
    with pytest.raises(ValueError, match="aux has shape"):
        TF.fused_ssa(*args, torch.from_numpy(table[:, :5]), 0.3, **kw)
    with pytest.raises(ValueError, match="aux has shape"):
        TF.fused_ssa(*args, torch.ones((3, 4, h * hd)), 0.3, **kw)
    with pytest.raises(ValueError, match="even head_dim"):
        TF.fused_ssa(args[0], torch.zeros((3, d, h * 7)), None,
                     torch.zeros((2, l, 3)), 0.3,
                     **dict(kw, head_dim=7))
    # launch A takes any L, and head_dim up to 128
    with pytest.raises(ValueError, match="fused_ssa kernel takes"):
        TF.fused_ssa_cuda(args[0], torch.zeros((3, d, h * 136)), None,
                          torch.zeros((2, l, 68)), 0.3,
                          **dict(kw, head_dim=136))
    assert TF.LAUNCHES["fused_ssa_rope"] == 0


def _block(jcfg, seed, quant_qkv):
    """Layer 0 of a dyadic JAX SMOKE init (BN biases raised so q/k/v
    fire), optionally with int8 q/k/v codes, and its BN state."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.round(a * 256) / 256),
        JR.init(jcfg, jax.random.PRNGKey(seed)))
    bp = jax.tree_util.tree_map(lambda a: np.asarray(a[0]), params["blocks"])
    st = jax.tree_util.tree_map(lambda a: np.asarray(a[0]),
                                JR.init_state(jcfg)["blocks"])
    for n in "qkv":
        bp[f"bn_{n}"]["bias"] = (0.25 + dyadic(rng, jcfg.q_dim) * 0.5)
        rows = bn_rows(rng, jcfg.q_dim)
        st[f"bn_{n}"] = {"mean": rows[0], "var": rows[1]}
    if quant_qkv:
        for w in ("wq", "wk", "wv"):
            bp[w] = jax.tree_util.tree_map(
                np.asarray, JQ.quantize_weight(jnp.asarray(bp[w]["w"]),
                                               "int8", dyadic=True))
    return bp, {n: st[n] for n in ("bn_q", "bn_k", "bn_v")}


@pytest.mark.parametrize("quant_qkv", [False, True])
def test_ssa_step_fused_matches_jax(quant_qkv):
    jcfg = jget_config(ARCH, smoke=True)
    tcfg = get_config(ARCH, smoke=True)
    bp, st = _block(jcfg, 3, quant_qkv)
    t, d = jcfg.spiking.time_steps, jcfg.d_model
    rng = np.random.default_rng(4)
    s = (rng.random((t, 2, 16, d)) < 0.3).astype(np.float32)
    s[0, 0] = 0.0
    want, _ = JE.ssa_step(bp, st, jcfg, jnp.asarray(s),
                          engine=jcfg.engine.replace(overlap="fused"))
    tbp = interop.to_torch(bp, device="cpu")
    tst = interop.to_torch(st, device="cpu")
    ts = torch.from_numpy(s)
    got, new_st = TE.ssa_step(tbp, tst, tcfg, ts,
                              engine=tcfg.engine.replace(overlap="fused"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.sum()) > 0
    assert all(new_st[k] is tst[k] for k in tst)
    seq, _ = TE.ssa_step(tbp, tst, tcfg, ts,
                         engine=tcfg.engine.replace(overlap="off"))
    assert torch.equal(got, seq)
    # the backward recomputes through the oracle: the sequential
    # composition's gradients (surrogate spikes included)
    g = torch.from_numpy(dyadic(rng, tuple(got.shape), bits=2))
    grads = []
    for ov in ("fused", "off"):
        leaf = ts.clone().requires_grad_()
        w = [tbp[n] for n in ("wq", "wk", "wv")]
        delta = tbp["delta"].clone().requires_grad_()
        if not quant_qkv:
            for p in w:
                p["w"] = p["w"].detach().requires_grad_()
        out, _ = TE.ssa_step(dict(tbp, delta=delta), tst, tcfg, leaf,
                             engine=tcfg.engine.replace(overlap=ov))
        out.backward(g)
        grads.append([leaf.grad, delta.grad]
                     + ([] if quant_qkv else [p["w"].grad for p in w]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _mixed_setup(select, dtype="int8", seed=0):
    """The SMOKE vision config with a mixed PTQ tree (dyadic scales) of
    the dyadic, firing params of the vision forward test."""
    from test_torch_spikingformer import _setup
    jcfg, tcfg, params, state, batch = _setup(ARCH, seed)
    jq = jax.tree_util.tree_map(
        np.asarray, JQ.quantize_tree(params, dtype, dyadic=True,
                                     select=select))
    return jcfg, tcfg, jq, state, batch


def MIXED(path):
    """int8 wo, w1, w2 and head; fp wq, wk, wv (the slice's tree)."""
    return path.rsplit("/", 1)[-1] not in ("wq", "wk", "wv")


def QKV(path):
    """The complementary tree: int8 wq, wk, wv only."""
    return path.rsplit("/", 1)[-1] in ("wq", "wk", "wv")


SELECT = {"mixed": MIXED, "qkv": QKV}


def _port_forward(tcfg, tree, state, batch, **engine):
    eng = tcfg.engine.replace(mode="sparse", overlap="fused", **engine)
    with TE.use_engine(eng), torch.inference_mode():
        logits, aux = TR.forward(interop.to_torch(tree, device="cpu"), tcfg,
                                 interop.to_torch(batch, device="cpu"),
                                 state=interop.to_torch(state, device="cpu"))
    return logits.numpy(), float(aux["fire_rate"])


def test_mixed_tree_forward_matches_jax():
    """The slice's main path at SMOKE size: JAX's forward under the same
    engine (overlap='fused', mode='sparse', tile), which runs the Pallas
    fused_ssa and quant_spike_matmul, and JAX's sequential oracle; the
    port with the tile and the decoded datapath. Logits bitwise."""
    jcfg, tcfg, jq, state, batch = _mixed_setup(MIXED)
    assert "qw" in jq["blocks"]["wo"] and "w" in jq["blocks"]["wq"]
    assert "qw" in jq["head"]
    fwd = jax.jit(lambda p, b, s: JR.forward(p, jcfg, b, state=s)[0])
    with JE.use_engine(jcfg.engine.replace(overlap="fused", mode="sparse",
                                           sparse="tile")):
        want = np.asarray(fwd(jq, batch, state))
    with JE.use_engine(jcfg.engine.replace(overlap="off", mode="dense")):
        oracle = np.asarray(jax.jit(
            lambda p, b, s: JR.forward(p, jcfg, b, state=s)[0])(
                jq, batch, state))
    np.testing.assert_array_equal(want, oracle)
    assert np.isfinite(want).all() and want.std() > 0
    for sparse in ("tile", "decoded"):
        got, fire = _port_forward(tcfg, jq, state, batch, sparse=sparse)
        np.testing.assert_array_equal(got, want, err_msg=sparse)
        assert 0 < fire < 1


@pytest.mark.parametrize("select,dtype", [("qkv", "int8"), ("mixed", "int4")])
def test_other_mixed_trees_match_jax_oracle(select, dtype):
    """The complementary tree (int8 q/k/v: the bundle kernel on codes and
    scale3, the fp spike products for wo / w1 / w2) and the int4 mixed
    tree (codes unpacked to int8 before the kernels) against JAX's
    sequential oracle, bitwise, with both datapaths."""
    jcfg, tcfg, jq, state, batch = _mixed_setup(SELECT[select], dtype,
                                                seed=1)
    with JE.use_engine(jcfg.engine.replace(overlap="off", mode="dense")):
        want = np.asarray(jax.jit(
            lambda p, b, s: JR.forward(p, jcfg, b, state=s)[0])(
                jq, batch, state))
    assert np.isfinite(want).all() and want.std() > 0
    for sparse in ("tile", "decoded"):
        got, fire = _port_forward(tcfg, jq, state, batch, sparse=sparse)
        np.testing.assert_array_equal(got, want, err_msg=sparse)
        assert 0 < fire < 1


def test_interop_carries_mixed_tree_leaf_for_leaf():
    for select, dtype in ((MIXED, "int8"), (MIXED, "int4"), (QKV, "int8")):
        _, _, jq, _, _ = _mixed_setup(select, dtype)
        flat, _ = jax.tree_util.tree_flatten_with_path(jq)
        tree = interop.to_torch(jq, device="cpu")
        for path, leaf in flat:
            node = tree
            for key in path:
                node = node[getattr(key, "key", getattr(key, "idx", None))]
            np.testing.assert_array_equal(node.numpy(), leaf)
            assert node.numpy().dtype == leaf.dtype, path
