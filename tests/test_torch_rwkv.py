"""The port's RWKV family (``repro_torch.models.rwkv``: rwkv6-3b) against
the JAX package at the SMOKE size (fp32), on numpy-seeded inputs and
JAX's own parameters (``repro.models.registry.init`` through
``interop``).

Tolerances, and why:
* the WKV forms (``_wkv_scan``, ``_wkv_chunked``) against their JAX
  twins within REL = 1e-6 of the largest output (or state) magnitude:
  fp32 sums of head_size products and per-chunk cumulative log sums in
  another order (XLA's cumsum and dot, torch's), a few ulps of the
  largest term;
* the chunked form against the scan within JAX's own 5e-4
  (``tests/test_rwkv_chunked.py``: the two forms sum in other orders
  and the chunk rescales by exponentials);
* ``layernorm`` / ``groupnorm`` within 1e-6 relative (JAX's
  ``lax.rsqrt`` and ``torch.rsqrt`` differ by an ulp or two, as for
  rmsnorm);
* logits of forwards and decode steps within LOGIT_ATOL = 2e-5,
  ``test_torch_dense.py``'s tolerance (the norms' rsqrt, the WKV's sums
  and the projections round apart from XLA's through 2 layers); the
  decode against the forward within the same (JAX's own test allows
  2e-4);
* one train step with ``tests/_torch_train_helpers.check_train_step``'s
  tolerances; int8 codes and scales bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import nn as JN  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import rwkv as JRW  # noqa: E402
from repro.quant import quantize_tree as jquantize_tree  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import rwkv as TRW  # noqa: E402
from repro_torch.quant import quantize_tree  # noqa: E402

from _torch_train_helpers import check_train_step, rel_close  # noqa: E402

ARCH = "rwkv6-3b"
LOGIT_ATOL = 2e-5
REL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def _setup(wkv_chunk=None):
    """(jcfg, cfg, JAX params as numpy, the port's tensors), cached;
    ``wkv_chunk`` overrides SMOKE's (0: the scan)."""
    if wkv_chunk not in _SETUPS:
        jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH,
                                                               smoke=True)
        if wkv_chunk is not None:
            jcfg = jcfg.replace(rwkv=dataclasses.replace(
                jcfg.rwkv, wkv_chunk=wkv_chunk))
            cfg = cfg.replace(rwkv=dataclasses.replace(
                cfg.rwkv, wkv_chunk=wkv_chunk))
        jp = jax.tree_util.tree_map(
            np.asarray, JR.init(jcfg, jax.random.PRNGKey(0)))
        _SETUPS[wkv_chunk] = (jcfg, cfg, jp, interop.to_torch(jp,
                                                               device="cpu"))
    return _SETUPS[wkv_chunk]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _wkv_inputs(seed, b, s, h, n, lo, hi):
    """r, k, v, w, u, state: the decays ``exp(-exp(x))``, x uniform in
    [lo, hi] (RWKV6's parameterization), a random start state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(lo, hi, (b, s, h, n)))).astype(
        np.float32)
    u = (rng.normal(0, 1, (h, n)) * 0.1).astype(np.float32)
    st = rng.normal(0, 1, (b, h, n, n)).astype(np.float32)
    return r, k, v, w, u, st


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# configs, init, layers
# ---------------------------------------------------------------------------


def test_config_and_init_mirror_jax():
    """CONFIG and SMOKE field by field (the RWKV config too), the arch in
    ``ALL_ARCHS``; the init tree has JAX's layout, shapes and dtypes in
    fp32 and bf16 (w0, B_w and u stay fp32)."""
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
                                 cfg.replace(dtype="bfloat16"))):
        want = jax.eval_shape(lambda: JR.init(jc, jax.random.PRNGKey(0)))
        mine = interop.to_numpy(registry.init(tc, 3, device="cpu"))
        assert jax.tree_util.tree_structure(want) == \
            jax.tree_util.tree_structure(mine)
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(mine)):
            assert a.shape == b.shape and a.dtype == b.dtype
        assert mine["layers"]["tm"]["u"].dtype == np.float32


def test_layernorm_and_groupnorm_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.normal(0, 2, (3, 7, 64)) + 1).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, 64).astype(np.float32),
         "bias": rng.normal(0, 0.1, 64).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = np.asarray(jax.jit(JN.layernorm)(p, x))
    rel_close(nn.layernorm(tp, torch.from_numpy(x)).numpy(), want, REL,
              "layernorm")
    want = np.asarray(jax.jit(lambda p, x: JN.groupnorm(p, x, 4))(p, x))
    rel_close(nn.groupnorm(tp, torch.from_numpy(x), 4).numpy(), want, REL,
              "groupnorm")


def test_wkv_scan_matches_jax():
    """The per-token recurrence from a random state on 37 tokens: outputs
    and final state within REL of JAX's."""
    args = _wkv_inputs(0, 2, 37, 2, 16, -5.0, -0.5)
    jy, js = jax.jit(JRW._wkv_scan)(*args)
    ty, ts = TRW._wkv_scan(*_torch(*args))
    rel_close(ty.numpy(), jy, REL, "y")
    rel_close(ts.numpy(), js, REL, "state")


@pytest.mark.parametrize("chunk, s", [(8, 37), (32, 64)])
def test_wkv_chunked_matches_jax_and_the_scan(chunk, s):
    """The chunk-parallel form (37 tokens: padded to whole chunks) within
    REL of JAX's ``_wkv_chunked``, and within JAX's 5e-4 of the port's
    own scan (JAX's ``test_chunked_matches_scan_realistic_decay``)."""
    args = _wkv_inputs(1, 2, s, 2, 16, -5.0, -0.5)
    jy, js = jax.jit(lambda *a: JRW._wkv_chunked(*a, chunk=chunk))(*args)
    ty, ts = TRW._wkv_chunked(*_torch(*args), chunk=chunk)
    rel_close(ty.numpy(), jy, REL, "y")
    rel_close(ts.numpy(), js, REL, "state")
    sy, ss = TRW._wkv_scan(*_torch(*args))
    np.testing.assert_allclose(ty.numpy(), sy.numpy(), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(ts.numpy(), ss.numpy(), atol=5e-4, rtol=5e-4)


def test_wkv_chunked_carries_state_across_calls():
    """Two calls of 32 tokens == one of 64 (JAX's own property)."""
    r, k, v, w, u, st = _torch(*_wkv_inputs(2, 1, 64, 2, 16, -5.0, -1.0))
    st = torch.zeros_like(st)
    y_full, st_full = TRW._wkv_chunked(r, k, v, w, u, st, chunk=16)
    y1, st1 = TRW._wkv_chunked(r[:, :32], k[:, :32], v[:, :32], w[:, :32],
                               u, st, chunk=16)
    y2, st2 = TRW._wkv_chunked(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:],
                               u, st1, chunk=16)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st2.numpy(), st_full.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_wkv_clamp_constant_is_subnormal_and_xla_flushes_it():
    """JAX's ``_wkv_chunked`` clamps w at 1e-38, below fp32's smallest
    normal: XLA on the CPU flushes it, so where a decay is 0 (or 1e-39)
    JAX's log is -inf and its chunked WKV gives NaN. torch keeps the
    subnormal (log -87.5): the port's output is finite, and its carried
    state equals the scan's within JAX's harsh-decay tolerance (atol
    1e-4, rtol 1e-3, ``test_chunked_harsh_decay_state_still_exact``: the
    clip distorts only the intra-chunk terms of such decays). Pinned
    (ROADMAP queue 3)."""
    args = list(_wkv_inputs(3, 1, 16, 1, 16, -5.0, -0.5))
    args[5] = np.zeros_like(args[5])
    args[3][0, 3, 0, :4] = 0.0
    args[3][0, 5, 0, 4:8] = 1e-39
    assert np.isneginf(np.asarray(jax.jit(
        lambda w: jnp.log(jnp.maximum(w, 1e-38)))(args[3]))).any()
    jy, _ = jax.jit(lambda *a: JRW._wkv_chunked(*a, chunk=8))(*args)
    assert np.isnan(np.asarray(jy)).any()
    assert float(torch.log(torch.clamp_min(torch.tensor(0.0), 1e-38))) \
        == pytest.approx(-87.498, abs=1e-3)
    ty, ts = TRW._wkv_chunked(*_torch(*args), chunk=8)
    _, ss = TRW._wkv_scan(*_torch(*args))
    assert bool(torch.isfinite(ty).all())
    np.testing.assert_allclose(ts.numpy(), ss.numpy(), atol=1e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# the family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wkv_chunk", [None, 8])
def test_forward_logits_match_jax(wkv_chunk):
    """2 x 20 tokens through ``build_prefill_step``: SMOKE (the scan) and
    with ``wkv_chunk`` 8 (the chunked form, 20 tokens padded to 24);
    ``inputs_embeds`` in place of the lookup gives the same."""
    jcfg, cfg, jp, tp = _setup(wkv_chunk)
    tok = _tokens(cfg, (2, 20), 1)
    jl, _ = jax.jit(lambda p, t: JR.forward(p, jcfg, {"tokens": t}))(jp, tok)
    got = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float32 and got.shape == jl.shape
    _close(got, jl, LOGIT_ATOL)
    embeds = tp["embed"]["table"][torch.from_numpy(tok).long()]
    again, _ = TRW.forward(tp, cfg, {"tokens": None}, inputs_embeds=embeds)
    assert torch.equal(again, got)


@pytest.mark.parametrize("wkv_chunk", [None, 8])
def test_token_by_token_decode_matches_forward_and_jax(wkv_chunk):
    """JAX's ``test_decode_matches_forward`` case (2 rows, 10 tokens, a
    cache of 24): the port's decode steps through ``build_serve_step``
    against its forward and against JAX's steps (logits within
    LOGIT_ATOL, the states within REL); the cache is updated in place. A
    prompt of several tokens through one decode call continues the state
    as the scan would."""
    jcfg, cfg, jp, tp = _setup(wkv_chunk)
    tok = _tokens(cfg, (2, 10), 1)
    jcache = JR.init_cache(jcfg, 2, 24)
    cache = registry.init_cache(cfg, 2, 24, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos: JR.decode_step(p, jcfg, c, t, pos))
    step = steps.build_serve_step(cfg, device="cpu")
    outs = []
    for i in range(10):
        jl, jcache = jstep(jp, jcache, tok[:, i:i + 1], i)
        tl, again = step(tp, cache, torch.from_numpy(tok[:, i:i + 1]), i)
        assert again is cache
        _close(tl, jl, LOGIT_ATOL)
        outs.append(tl)
    for key in jcache:
        rel_close(cache[key].numpy(), jcache[key], REL, key)
    pre = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(tok)})
    _close(torch.cat(outs, dim=1), pre, LOGIT_ATOL)
    whole = registry.init_cache(cfg, 2, 24, device="cpu")
    tl, whole = registry.decode_step(tp, cfg, whole, torch.from_numpy(tok), 0)
    _close(tl, pre, LOGIT_ATOL)
    with pytest.raises(TypeError, match="n_tok"):
        registry.decode_step(tp, cfg, whole, torch.from_numpy(tok[:, :1]),
                             0, n_tok=torch.ones(2))


def test_train_step_matches_jax():
    """One AdamW step of rwkv6-3b SMOKE on 2 x 10 tokens against the
    jitted JAX step: loss, gradients (the bare LoRA and decay leaves
    too), grad norm, params."""
    jcfg, cfg, jp, _ = _setup()
    check_train_step(jcfg, cfg, jp, None, {"tokens": _tokens(cfg, (2, 10),
                                                             9)})


def test_quantize_tree_int8_leaves_match_jax():
    """``quantize_tree(..., 'int8')``: JAX's int8 leaves (the {"w"}
    linears; the bare LoRA matrices, mixes and decays stay fp), codes and
    scales bitwise; the int8 forward within LOGIT_ATOL of JAX's."""
    jcfg, cfg, jp, tp = _setup()
    jq = jax.tree_util.tree_map(np.asarray, jquantize_tree(jp, "int8"))
    tq = interop.to_numpy(quantize_tree(tp, "int8"))
    assert jax.tree_util.tree_structure(jq) == \
        jax.tree_util.tree_structure(tq)
    paths = lambda t: sorted(jax.tree_util.keystr(p) for p, leaf in
                             jax.tree_util.tree_flatten_with_path(t)[0]
                             if leaf.dtype == np.int8)
    assert paths(tq) == paths(jq) and len(paths(tq)) == 9
    for a, b in zip(jax.tree_util.tree_leaves(jq),
                    jax.tree_util.tree_leaves(tq)):
        np.testing.assert_array_equal(a, b)
    tok = _tokens(cfg, (2, 8), 4)
    jl, _ = jax.jit(lambda p, t: JR.forward(p, jcfg, {"tokens": t}))(jq, tok)
    tl, _ = registry.forward(interop.to_torch(tq, device="cpu"), cfg,
                             {"tokens": torch.from_numpy(tok)})
    _close(tl, jl, LOGIT_ATOL)


def test_batched_server_refuses_rwkv_as_jax():
    """No per-slot decode state: ``BatchedServer`` refuses the family in
    both packages with the error naming slots (JAX's
    ``test_serve.py::test_rejects_unslotted_family``)."""
    from repro.launch import serve as JS
    jcfg, cfg, jp, tp = _setup()
    assert not registry.supports_slots(cfg) and registry.has_decode(cfg)
    with pytest.raises(ValueError, match="slot"):
        JS.BatchedServer(jcfg, jp, 2, 16)
    with pytest.raises(ValueError, match="slot"):
        TSV.BatchedServer(cfg, tp, 2, 16, device="cpu")
