"""Gradients through the port's layer program (``core/engine._FusedLayer``).

On the card the layer program is a CUDA kernel that writes fresh tensors
through ctypes, outside autograd. ``_FusedLayer`` gives it the backward
of JAX's ``_fused_layer`` custom VJP: the sequential oracle
``reference_layer`` recomputed on the saved operands and differentiated.
Here the launcher is stood in for by the plain version with its outputs
detached, which is what the kernel hands back, so the tests show both the
fault (no gradient through the launcher itself) and its repair: an
eval-mode forward of the SMOKE Spikingformer-4-256 (bn family, dyadic
weights that fire) and of the SMOKE fp32 spikingformer-lm (rope family)
under ``overlap='fused'`` gives every layer parameter the gradient it
gets under ``overlap='off'``, bitwise (the fused forward equals the
oracle bitwise on these inputs, and the backward is the oracle's).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core.spiking import SpikingConfig  # noqa: E402
from repro_torch.kernels import fused_layer as TFL  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

from _torch_helpers import layer_ops, to_torch  # noqa: E402
from test_torch_spikingformer import _setup  # noqa: E402


@pytest.fixture
def detached_launcher(monkeypatch):
    """``fused_layer`` returning fresh tensors outside autograd, as the
    CUDA launcher does; counts its calls."""
    calls = []
    real = TFL.fused_layer

    def launcher(*args, **kw):
        out, counts = real(*args, **kw)
        calls.append(kw["family"])
        return out.detach().clone(), counts
    monkeypatch.setattr(TFL, "fused_layer", launcher)
    return calls


def _model(family):
    """(config, params, forward kwargs, batch) at SMOKE size."""
    if family == "bn":
        _, cfg, params, state, batch = _setup("spikingformer-4-256", seed=2)
        return (cfg, interop.to_torch(params, device="cpu"),
                {"state": interop.to_torch(state, device="cpu")},
                interop.to_torch(batch, device="cpu"))
    from repro_torch.configs import get_config
    cfg = get_config("spikingformer-lm", smoke=True)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 11))
    return (cfg, registry.init(cfg, 0, device="cpu"), {},
            {"tokens": torch.from_numpy(toks)})


def _grads(cfg, params, kw, batch, overlap):
    """(logits, gradients of every layer parameter) of an eval-mode
    forward under ``overlap``, for one fixed cotangent."""
    layers = "blocks" if "blocks" in params else "layers"
    leaves = [a.detach().requires_grad_() for a in
              tree_leaves(params[layers])]
    tree = dict(params, **{layers: tree_unflatten(params[layers], leaves)})
    with E.use_engine(cfg.engine.replace(overlap=overlap)):
        logits, _ = registry.forward(tree, cfg, batch, **kw)
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(logits.shape)).astype(np.float32))
    grads = torch.autograd.grad((logits * cot).sum(), leaves,
                                allow_unused=True)
    return logits.detach(), grads


@pytest.mark.parametrize("family", ["bn", "rope"])
def test_gradients_through_the_layer_program_equal_off(family,
                                                       detached_launcher):
    cfg, params, kw, batch = _model(family)
    fused, g_fused = _grads(cfg, params, kw, batch, "fused")
    assert detached_launcher == [family] * cfg.num_layers
    off, g_off = _grads(cfg, params, kw, batch, "off")
    assert len(detached_launcher) == cfg.num_layers
    assert torch.equal(fused, off) and float(fused.std()) > 0
    for a, b in zip(g_fused, g_off):
        assert a is not None and b is not None
        assert torch.equal(a, b)
    # the projections, wo and the MLP get non-zero gradients
    layers = params["blocks" if family == "bn" else "layers"]
    names = ["wq", "wo"] + (["w1", "w2"] if family == "bn"
                            else ["mlp/up", "mlp/down"])
    flat = dict(zip(_paths(layers), g_fused))
    for name in names:
        assert float(flat[f"{name}/w"].abs().sum()) > 0, name


@pytest.mark.parametrize("family", ["bn", "rope"])
def test_gradients_under_pipeline_equal_off(family, detached_launcher,
                                           monkeypatch):
    """overlap='pipeline' runs the same ``_FusedLayer`` with the pipelined
    launcher (one layer call a layer, its pipelined plain version); its
    backward is the oracle's, so logits and every layer parameter's
    gradient equal overlap='off', bitwise."""
    cfg, params, kw, batch = _model(family)
    pipelined = []
    real = TFL.fused_layer_pipeline_plain
    monkeypatch.setattr(TFL, "fused_layer_pipeline_plain",
                        lambda *a, **k: pipelined.append(1) or real(*a, **k))
    pipe, g_pipe = _grads(cfg, params, kw, batch, "pipeline")
    assert detached_launcher == [family] * cfg.num_layers
    assert len(pipelined) == cfg.num_layers
    off, g_off = _grads(cfg, params, kw, batch, "off")
    assert torch.equal(pipe, off) and float(pipe.std()) > 0
    for a, b in zip(g_pipe, g_off):
        assert a is not None and b is not None
        assert torch.equal(a, b)


def test_the_launcher_alone_gives_no_gradient(detached_launcher):
    """The fault the autograd Function repairs: the launcher's output has
    no path back to the layer's weights; through ``_FusedLayer`` it has
    the oracle's."""
    heads, hd = 2, 8
    args = list(to_torch(layer_ops(1, 2, 1, 5, 16, heads, hd, 16)))
    w3 = args[2].requires_grad_()
    kw = dict(family="bn", num_heads=heads, head_dim=hd, scale=hd ** -0.5)
    out, _ = TFL.fused_layer(*args, **kw)
    assert out.grad_fn is None and not out.requires_grad
    spec = E.LayerSpec(causal=False, scfg=SpikingConfig(time_steps=2),
                       eps=1e-5, norm_eps=1e-6, sparse="tile", l_block=128,
                       c_block=128, overlap="fused", **kw)
    scales = (torch.ones((3, heads * hd)), torch.ones(16), torch.ones(16),
              torch.ones(16))
    y = E._FusedLayer.apply(*args[:6], *scales, *args[7:11],
                            torch.tensor(0.3), spec)
    (g,) = torch.autograd.grad(y.sum(), w3)
    ref = TFL.reference_layer(*args[:6], scales, *args[7:11], 0.3,
                              SpikingConfig(time_steps=2), **kw)
    (want,) = torch.autograd.grad(ref.sum(), w3)
    assert torch.equal(y, ref) and torch.equal(g, want)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}{k}/")]
    return [prefix[:-1]]
