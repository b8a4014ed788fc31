"""The port's encoder-decoder family (``repro_torch.models.encdec``:
whisper-small's backbone behind stub frame embeddings) against the JAX
package at the SMOKE size (fp32), on numpy-seeded inputs and JAX's own
parameters (``repro.models.registry.init`` through ``interop``).

Tolerances, and why:
* ``sinusoid_positions``: jitted XLA's fp32 power ``10000^(2i/d)``
  differs from torch's (at d 768 on 118 of 384 exponents), by a
  relative ``r`` this test measures on the two tables; an angle ``pos /
  power`` then differs by at most ``|angle| (r + 2^-22)`` (r plus each
  side's rounding of the quotient), which sin and cos pass on with a
  derivative of at most 1, and each side's sin / cos adds at most
  2^-23 (the port's: float64 values rounded once; XLA's fp32 ones);
* GELU: the tanh approximation, as ``jax.nn.gelu``, within 1e-6
  absolute (XLA's tanh saturates to -1 from an argument near 8, where
  torch's keeps 1 - 1.8e-7: a far-tail value moves by up to 5e-7);
  ``F.gelu``'s erf default lies more than 1e-4 away;
* logits of forwards and decode steps within LOGIT_ATOL = 2e-5,
  ``test_torch_dense.py``'s tolerance (layernorm's rsqrt, the softmax
  attentions and the projections round apart from XLA's through 2 + 2
  layers); the cross K / V within the same;
* one train step with ``tests/_torch_train_helpers.check_train_step``'s
  tolerances; int8 codes and scales bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import nn as JN  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.quant import quantize_tree as jquantize_tree  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.quant import quantize_tree  # noqa: E402

from _torch_train_helpers import check_train_step  # noqa: E402

ARCH = "whisper-small"
LOGIT_ATOL = 2e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUP = []


def _setup():
    """(jcfg, cfg, JAX params as numpy, the port's tensors), cached."""
    if not _SETUP:
        jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH,
                                                               smoke=True)
        jp = jax.tree_util.tree_map(
            np.asarray, JR.init(jcfg, jax.random.PRNGKey(0)))
        _SETUP.append((jcfg, cfg, jp, interop.to_torch(jp, device="cpu")))
    return _SETUP[0]


def _batch(cfg, b, s, seed):
    """Tokens and stub frames of std 0.1 (JAX's test_models case)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "audio_embeds": rng.normal(0, 0.1, (b, cfg.encoder_seq,
                                                cfg.d_model)).astype(
                np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def test_config_and_init_mirror_jax():
    """CONFIG and SMOKE field by field (the frontend config too), the arch
    in ``ALL_ARCHS``; the init tree has JAX's layout, shapes and dtypes in
    fp32 and bf16."""
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


@pytest.mark.parametrize("length, d", [(12, 64), (1500, 768)])
def test_sinusoid_positions_match_jax(length, d):
    """SMOKE's table and whisper-small's 1500 x 768 one."""
    want = np.asarray(jax.jit(lambda: JN.sinusoid_positions(length, d))())
    got = nn.sinusoid_positions(length, d).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    dim = np.arange(d // 2, dtype=np.float32)
    jpow = np.asarray(jax.jit(lambda x: jax.numpy.power(10000.0, 2 * x / d))(
        dim), np.float64)
    tpow = torch.pow(torch.tensor(10000.0), 2 * torch.from_numpy(dim) / d
                     ).double().numpy()
    r = np.abs(jpow / tpow - 1).max()
    ang = np.arange(length, dtype=np.float64)[:, None] / tpow
    bound = np.abs(np.concatenate([ang, ang], -1)) * (r + 2.0 ** -22) \
        + 2.0 ** -23
    assert (np.abs(got - want) <= bound).all()


def test_gelu_is_jax_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh approximation, which
    ``F.gelu``'s erf default is not."""
    x = np.linspace(-6, 6, 241).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.gelu)(x))
    got = nn.activation("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("s", [10, 70])
def test_forward_logits_match_jax(s):
    """2 x ``s`` tokens after 12 stub frames through
    ``build_prefill_step``; at 70 tokens past the 64 learned positions the
    forward appends sinusoid rows, in both packages."""
    jcfg, cfg, jp, tp = _setup()
    batch = _batch(cfg, 2, s, 1)
    jl, _ = jax.jit(lambda p, b: JR.forward(p, jcfg, b))(jp, batch)
    got = steps.build_prefill_step(cfg, device="cpu")(tp, _tb(batch))
    assert got.dtype == torch.float32 and got.shape == jl.shape
    _close(got, jl, LOGIT_ATOL)


def test_token_by_token_decode_matches_forward_and_jax():
    """JAX's ``test_decode_matches_forward`` case (2 rows, 10 tokens, a
    cache of 24, cross K / V from ``init_cache(batch=, params=)``): the
    port's cross K / V and steps against JAX's, and its steps against its
    forward."""
    jcfg, cfg, jp, tp = _setup()
    batch = _batch(cfg, 2, 10, 1)
    jcache = JR.init_cache(jcfg, 2, 24, batch=batch, params=jp)
    cache = registry.init_cache(cfg, 2, 24, batch=_tb(batch), params=tp,
                                device="cpu")
    for key in ("cross_k", "cross_v"):
        _close(cache[key], jcache[key], LOGIT_ATOL)
    jstep = jax.jit(lambda p, c, t, pos: JR.decode_step(p, jcfg, c, t, pos))
    step = steps.build_serve_step(cfg, device="cpu")
    tok, outs = batch["tokens"], []
    for i in range(10):
        jl, jcache = jstep(jp, jcache, tok[:, i:i + 1], i)
        tl, cache = step(tp, cache, torch.from_numpy(tok[:, i:i + 1]), i)
        _close(tl, jl, LOGIT_ATOL)
        outs.append(tl)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    pre = steps.build_prefill_step(cfg, device="cpu")(tp, _tb(batch))
    _close(torch.cat(outs, dim=1), pre, LOGIT_ATOL)
    with pytest.raises(TypeError, match="n_tok"):
        registry.decode_step(tp, cfg, cache, torch.from_numpy(tok[:, :1]),
                             0, n_tok=torch.ones(2))


def test_decode_past_the_learned_positions_follows_jax_not_the_forward():
    """70 tokens decoded into a cache of 66 (SMOKE's table has 64 rows):
    from position 64 decode reads the table's last row where the forward
    appends sinusoid rows, and positions 66-69 write the cache's last
    entry (``dynamic_update_slice`` clamps its start), in both packages.
    The port's steps equal JAX's throughout; they equal the forward
    before position 64 and depart from it after (ROADMAP queue 3)."""
    jcfg, cfg, jp, tp = _setup()
    batch = _batch(cfg, 2, 70, 2)
    tok = batch["tokens"]
    jcache = JR.init_cache(jcfg, 2, 66, batch=batch, params=jp)
    cache = registry.init_cache(cfg, 2, 66, batch=_tb(batch), params=tp,
                                device="cpu")
    jstep = jax.jit(lambda p, c, t, pos: JR.decode_step(p, jcfg, c, t, pos))
    step = steps.build_serve_step(cfg, device="cpu")
    outs = []
    for i in range(70):
        jl, jcache = jstep(jp, jcache, tok[:, i:i + 1], i)
        tl, cache = step(tp, cache, torch.from_numpy(tok[:, i:i + 1]), i)
        _close(tl, jl, LOGIT_ATOL)
        outs.append(tl)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert int(cache["pos"][0, -1]) == 69
    dec = torch.cat(outs, dim=1)
    pre = steps.build_prefill_step(cfg, device="cpu")(tp, _tb(batch))
    _close(dec[:, :64], pre[:, :64], LOGIT_ATOL)
    assert float((dec[:, 64:] - pre[:, 64:]).abs().max()) > 1e-2


def test_train_step_matches_jax():
    """One AdamW step of whisper-small SMOKE on 2 x 10 tokens and 12 stub
    frames against the jitted JAX step: loss, gradients (encoder,
    decoder, learned positions, the tied embedding), grad norm,
    params."""
    jcfg, cfg, jp, _ = _setup()
    check_train_step(jcfg, cfg, jp, None, _batch(cfg, 2, 10, 9))


def test_quantize_tree_int8_leaves_match_jax():
    """``quantize_tree(..., 'int8')``: JAX's int8 leaves (every attention
    and MLP projection of both stacks; the tied embedding and positions
    stay fp), codes and scales bitwise; the int8 forward within
    LOGIT_ATOL of JAX's. ``BatchedServer`` refuses the family in both
    packages."""
    from repro.launch import serve as JS
    jcfg, cfg, jp, tp = _setup()
    jq = jax.tree_util.tree_map(np.asarray, jquantize_tree(jp, "int8"))
    tq = interop.to_numpy(quantize_tree(tp, "int8"))
    assert jax.tree_util.tree_structure(jq) == \
        jax.tree_util.tree_structure(tq)
    paths = lambda t: sorted(jax.tree_util.keystr(p) for p, leaf in
                             jax.tree_util.tree_flatten_with_path(t)[0]
                             if leaf.dtype == np.int8)
    assert paths(tq) == paths(jq) and len(paths(tq)) == 16
    for a, b in zip(jax.tree_util.tree_leaves(jq),
                    jax.tree_util.tree_leaves(tq)):
        np.testing.assert_array_equal(a, b)
    batch = _batch(cfg, 2, 8, 4)
    jl, _ = jax.jit(lambda p, b: JR.forward(p, jcfg, b))(jq, batch)
    tl, _ = registry.forward(interop.to_torch(tq, device="cpu"), cfg,
                             _tb(batch))
    _close(tl, jl, LOGIT_ATOL)
    with pytest.raises(ValueError, match="slot"):
        JS.BatchedServer(jcfg, jp, 2, 16)
    with pytest.raises(ValueError, match="slot"):
        TSV.BatchedServer(cfg, tp, 2, 16, device="cpu")
