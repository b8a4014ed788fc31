"""The port's Spikingformer inference slice against the JAX package.

* whole forward: JAX ``registry.init`` params (dyadic-rounded) and a BN
  state with agreeing variances, converted by ``repro_torch.interop``;
  the port's forward with ``overlap`` off, fused with the tile path and
  fused with the decoded path equals jitted JAX ``registry.forward``
  (overlap off) bitwise on the logits, for both vision SMOKE configs;
  ``layer_sparsities`` equals JAX's;
* entry point: the port's ``build_prefill_step`` against JAX's on
  ``init_state`` (var = 1, where XLA's and torch's rsqrt differ by one
  ulp), within a stated tolerance and with the same argmax;
* interop round trip, init tree layout, dispatch rules on CPU and CUDA
  tensors, the GPU default of every entry point, and that the port and
  ``chip_smoke.py`` import neither ``jax`` nor ``repro``.
"""
import os
import subprocess
import sys
import textwrap
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.launch.steps import (  # noqa: E402
    build_prefill_step as jbuild_prefill)
from repro.models import registry as JR  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.launch.steps import build_prefill_step  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

from _torch_helpers import agreeing_variances, dyadic  # noqa: E402

ARCHS = ["spikingformer-4-256", "spikingformer-8-512"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(arch, seed=0):
    """(JAX cfg, port cfg, numpy params, numpy BN state, numpy batch):
    dyadic weights, BN affines and means; agreeing variances."""
    cfg = jget_config(arch, smoke=True)
    rng = np.random.default_rng(seed)
    params = _np_tree(jax.tree_util.tree_map(
        lambda a: jnp.round(a * 256) / 256,
        JR.init(cfg, jax.random.PRNGKey(seed))))
    for bn in [p["bn"] for p in params["sps"]] + [
            v for k, v in params["blocks"].items() if k.startswith("bn_")]:
        bn["scale"] = (1.0 + dyadic(rng, bn["scale"].shape) * 0.5
                       ).astype(bn["scale"].dtype)
        bn["bias"] = (0.25 + dyadic(rng, bn["bias"].shape) * 0.5
                      ).astype(bn["bias"].dtype)
    state = _np_tree(JR.init_state(cfg))
    for st in state["sps"] + list(state["blocks"].values()):
        st["mean"] = dyadic(rng, st["mean"].shape) * 0.25
        st["var"] = agreeing_variances(rng, st["var"].size).reshape(
            st["var"].shape)
    v = cfg.vision
    images = (rng.integers(0, 256, (2, v.img_size, v.img_size,
                                    v.in_channels)) / 256.0
              ).astype(np.float32)
    return cfg, get_config(arch, smoke=True), params, state, {"images": images}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bitwise_against_jitted_jax(arch):
    cfg, tcfg, params, state, batch = _setup(arch)
    with JE.use_engine(cfg.engine.replace(overlap="off")):
        want = np.asarray(jax.jit(
            lambda p, b, s: JR.forward(p, cfg, b, state=s)[0])(
                params, batch, state))
    assert np.isfinite(want).all() and want.std() > 0
    tp = interop.to_torch(params, device="cpu")
    ts = interop.to_torch(state, device="cpu")
    tb = interop.to_torch(batch, device="cpu")
    for overlap, sparse in (("off", "tile"), ("fused", "tile"),
                            ("fused", "decoded")):
        with TE.use_engine(tcfg.engine.replace(overlap=overlap,
                                               sparse=sparse)):
            logits, aux = TR.forward(tp, tcfg, tb, state=ts)
        np.testing.assert_array_equal(logits.numpy(), want,
                                      err_msg=f"{overlap} {sparse}")
        assert 0 < float(aux["fire_rate"]) < 1


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_sparsities_match_jax(arch):
    """Per-layer sparsity (Fig. 11) on the same params, state and images:
    the spikes agree bitwise, the means to 1e-6 (fp32 sums in another
    order)."""
    from repro.models.spikingformer import layer_sparsities as jsparsities
    from repro_torch.models.spikingformer import layer_sparsities
    cfg, tcfg, params, state, batch = _setup(arch, seed=2)
    with JE.use_engine(cfg.engine.replace(overlap="off")):
        want = jsparsities(params, cfg, batch, state)
    got = layer_sparsities(interop.to_torch(params, device="cpu"), tcfg,
                           interop.to_torch(batch, device="cpu"),
                           interop.to_torch(state, device="cpu"))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == cfg.num_layers + 1
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=1e-6)
    assert all(0 < v < 1 for _, v in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_against_jax_on_init_state(arch):
    """Both steps run on init_state (var = 1): the BN inverse std differs
    by one ulp between XLA and torch, so logits agree to 1e-5 (the
    tolerance of that ulp through a handful of BN layers and the rate
    head) rather than bitwise, with the same argmax."""
    cfg, tcfg, params, _, batch = _setup(arch, seed=1)
    want = np.asarray(jbuild_prefill(cfg)(params, batch))
    got = build_prefill_step(tcfg, device="cpu")(
        interop.to_torch(params, device="cpu"),
        interop.to_torch(batch, device="cpu")).numpy()
    assert want.std() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interop_round_trip_is_identity(dtype):
    cfg = jget_config("spikingformer-4-256", smoke=True).replace(dtype=dtype)
    tree = {"params": _np_tree(JR.init(cfg, jax.random.PRNGKey(3))),
            "state": _np_tree(JR.init_state(cfg))}
    back = interop.to_numpy(interop.to_torch(tree, device="cpu"))
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_layout_matches_jax(arch):
    cfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = _np_tree(JR.init(cfg, jax.random.PRNGKey(0)))
    tp = interop.to_numpy(TR.init(tcfg, 0, device="cpu"))
    js = _np_tree(JR.init_state(cfg))
    ts = interop.to_numpy(TR.init_state(tcfg, device="cpu"))
    for j, t in ((jp, tp), (js, ts)):
        jl, jdef = jax.tree_util.tree_flatten(j)
        tl, tdef = jax.tree_util.tree_flatten(t)
        assert jdef == tdef
        for a, b in zip(jl, tl):
            assert (a.shape, a.dtype) == (b.shape, b.dtype)
            if a.size > 64 and a.std() > 0:     # same init std
                assert 0.85 < b.std() / a.std() < 1.15
    np.testing.assert_array_equal(ts["blocks"]["bn_q"]["var"], 1.0)


def _on(kind):
    return types.SimpleNamespace(device=torch.device(kind))


def test_dispatch_rules_on_cpu_and_cuda_tensors():
    """'auto' fuses every layer on a CUDA tensor (the card has no flop
    floor: the kernel runs or raises) and takes the oracle on the CPU; the
    same rule sends spike products and spiking attention to their kernels
    on the card and to the plain paths on the CPU. sparse='auto' reads the
    spikes' occupancy on every device; explicit paths are honoured."""
    auto = TE.EngineConfig(overlap="auto", sparse="auto")
    assert not hasattr(auto, "min_flops")
    assert TE.resolve_overlap(auto, _on("cuda")) == "fused"
    assert TE.resolve_layer_plan(auto.replace(sparse="tile"),
                                 _on("cuda")) == ("fused", "tile")
    assert TE.resolve_overlap(auto, _on("cpu")) == "off"
    assert TE.resolve_overlap(auto, None) == "off"
    assert TE.resolve_overlap(None, _on("cuda")) == "off"
    assert TE.resolve_mode(auto, _on("cuda")) == "sparse"
    assert TE.resolve_binary_mode(auto, _on("cuda")) == "mxu_kernel"
    assert TE.resolve_mode(auto, _on("cpu")) == "dense"
    assert TE.resolve_binary_mode(auto, _on("cpu")) == "jnp"
    for ov in ("off", "fused"):
        eng = TE.EngineConfig(overlap=ov)
        for dev in ("cpu", "cuda"):
            assert TE.resolve_overlap(eng, _on(dev)) == ov
            assert TE.resolve_layer_plan(eng, _on(dev)) == (ov, "tile")
    dense = torch.ones((2, 1, 16, 64))
    assert TE.resolve_sparse_path(auto, dense) == "tile"
    assert TE.resolve_layer_plan(auto, dense) == ("off", "tile")
    for path in ("tile", "decoded"):
        for dev in ("cpu", "cuda"):
            assert TE.resolve_sparse_path(TE.EngineConfig(sparse=path),
                                          _on(dev)) == path
    # an explicit 'pipeline' is honoured on every device; 'auto' never
    # picks it
    for dev in ("cpu", "cuda"):
        pipe = TE.EngineConfig(overlap="pipeline")
        assert TE.resolve_overlap(pipe, _on(dev)) == "pipeline"
        assert TE.resolve_layer_plan(pipe, _on(dev)) == ("pipeline", "tile")
    # spike_linear (quantized weights on the dense and the sparse path),
    # the sequential ssa_step and the fused SSA bundle (kernel #6) are
    # ported: on CPU tensors the sparse path and the bundle take the
    # kernels' plain versions, equal to the dense and sequential paths
    from repro_torch.quant import quantize_weight
    tcfg = get_config("spikingformer-4-256", smoke=True)
    bp, st = _block_leaves(tcfg)
    s = torch.ones((2, 1, 16, tcfg.d_model))
    y = TE.spike_linear(bp["wq"], s, engine=TE.EngineConfig(mode="sparse"))
    assert y.shape == (2, 1, 16, tcfg.q_dim)
    qwq = quantize_weight(bp["wq"]["w"])
    assert TE.spike_linear(qwq, s).shape == (2, 1, 16, tcfg.q_dim)
    bundle_st = {n: st[n] for n in ("bn_q", "bn_k", "bn_v")}
    ctx, _ = TE.ssa_step(bp, bundle_st, tcfg, s,
                         engine=TE.EngineConfig(overlap="off"))
    assert ctx.shape == (2, 1, 16, tcfg.q_dim)
    assert torch.equal(
        TE.spike_linear(qwq, s, engine=TE.EngineConfig(mode="sparse")),
        TE.dense_quant_linear(qwq, s))
    fused, fused_st = TE.ssa_step(bp, bundle_st, tcfg, s,
                                  engine=TE.EngineConfig(overlap="fused"))
    assert torch.equal(fused, ctx) and fused_st == bundle_st
    for bad in (dict(overlap="x"), dict(sparse="x"), dict(mode="x"),
                dict(binary="x"), dict(weights="x")):
        with pytest.raises(ValueError):
            TE.EngineConfig(**bad)


def _block_leaves(tcfg):
    """Layer 0's params and BN state of a seeded SMOKE model (CPU)."""
    p = TR.init(tcfg, 0, device="cpu")
    st = TR.init_state(tcfg, device="cpu")["blocks"]
    layer0 = lambda tree: {k: (v[0] if torch.is_tensor(v) else layer0(v))
                           for k, v in tree.items()}
    return layer0(p["blocks"]), layer0(st)


def test_unported_layer_paths_raise():
    """Training runs now (train-mode forward and the sequential layer
    step), and so does the fused SSA bundle of an ineligible eval layer
    (equal to the sequential composition). The cifarnet family, a
    non-spiking dense model and an rwkv model, which raised here before
    they were ported, now build (``test_torch_cifarnet.py``,
    ``test_torch_dense.py``, ``test_torch_rwkv.py``). overlap='pipeline',
    which raised here before it was ported, now runs with either sparse
    path and equals overlap='fused' bitwise."""
    tcfg = get_config("spikingformer-4-256", smoke=True)
    p = TR.init(tcfg, 0, device="cpu")
    batch = {"images": torch.rand((2, 16, 16, 3))}
    logits, aux = TR.forward(p, tcfg, batch, train=True)
    assert logits.shape == (2, tcfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert float(aux["state"]["blocks"]["bn_q"]["mean"].abs().sum()) > 0
    bp, st = _block_leaves(tcfg)
    x = torch.rand((2, 1, 16, tcfg.d_model)) * 2
    y, new_st = TE.layer_step(bp, st, tcfg, x, train=True)
    assert y.shape == x.shape and set(new_st) == set(st)
    biased = dict(bp, wo=dict(bp["wo"], b=torch.zeros(tcfg.d_model)))
    dense = get_config("spikingformer-lm", smoke=True).replace(spiking=None)
    assert "delta" not in TR.init(dense, device="cpu")["layers"]
    # the rwkv family, which raised here before it was ported, builds its
    # tree (its forward is held against JAX in test_torch_rwkv.py)
    rwkv = get_config("rwkv6-3b", smoke=True)
    tree = TR.init(rwkv, device="cpu")
    assert set(tree["layers"]) == {"ln1", "tm", "ln2", "cm"}
    assert tree["layers"]["tm"]["u"].shape == (
        rwkv.num_layers, rwkv.d_model // rwkv.rwkv.head_size,
        rwkv.rwkv.head_size)
    for sparse in ("decoded", "tile"):
        runs = [TE.layer_step(bp, st, tcfg, x, engine=TE.EngineConfig(
            overlap=ov, sparse=sparse))[0] for ov in ("pipeline", "fused")]
        assert torch.equal(*runs) and float(runs[0].std()) > 0
    fused, _ = TE.layer_step(biased, st, tcfg, x,
                             engine=TE.EngineConfig(overlap="fused"))
    seq, _ = TE.layer_step(biased, st, tcfg, x,
                           engine=TE.EngineConfig(overlap="off"))
    assert torch.equal(fused, seq)


def test_entry_points_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = get_config("spikingformer-4-256", smoke=True)
    for call in (lambda: TR.init(tcfg, 0), lambda: TR.init_state(tcfg),
                 lambda: build_prefill_step(tcfg),
                 lambda: interop.to_torch({"a": np.zeros(2)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, load without jax or
    the JAX package (checked in a fresh interpreter)."""
    code = textwrap.dedent("""
        import importlib, importlib.util, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      "chip_smoke.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print(len([m for m in sys.modules if m.startswith("repro_torch")]))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 12
