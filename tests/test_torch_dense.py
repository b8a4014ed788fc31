"""The port's dense decoder family (``repro_torch.models.transformer``
without ``spiking``: nemotron-4-15b, gemma3-12b, h2o-danube-3-4b,
granite-20b) and the chunked attention dataflows of ``models/nn.py``
against the JAX package at the SMOKE size (fp32), on numpy-seeded
inputs and JAX's own parameters (``repro.models.registry.init`` through
``interop``).

Tolerances, and why:
* ``binary_flash_attention`` on {0,1} q / k / v bitwise: every score is
  an integer count, the threshold is the FMA jitted XLA contracts
  ``count * scale - delta`` into (``nn.fma32``), the context sums
  integers;
* the softmax attentions within 2e-6 absolute on values of order 1:
  torch's ``exp`` and XLA's differ by an ulp or two, and the fp32 dots
  sum in another order, so each weight carries a few ulp (2^-23 ~ 1.2e-7
  relative) and the output, a convex combination of |v| <= 4, a few
  times that;
* ``mlp`` within 1e-5 relative of its largest output: the products sum
  over d_ff in another order, and ``tanh`` / ``exp`` carry an ulp;
* logits of whole forwards, decode steps and server rows within 2e-5
  absolute (|logits| <= ~6): rmsnorm's rsqrt differs from XLA's by up to
  2 ulp (ROADMAP queue 3), the attention above, and the projections'
  sums in another order, through 2-4 layers (JAX's own chunked-prefill
  test fails at 2.3e-6 on exactly these fp32 orders, ROADMAP queue 3);
  decode against the port's own prefill within 2e-5 for the same reason
  (chunked softmax against one softmax over the cache);
* cache tags (positions) equal; K / V entries within the logits' 2e-5
  (a later layer projects a residual stream that carries the earlier
  layers' differences);
* one train step with ``tests/_torch_train_helpers.check_train_step``'s
  tolerances (the token family's loss within ``DENSE_LOSS_REL``);
* greedy tokens equal wherever the port's top-2 margin exceeds 1e-3, 50
  times the logits' tolerance.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import DENSE_ARCHS, get_config  # noqa: E402
from repro_torch.configs import shapes as TSH  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

from _torch_train_helpers import check_train_step  # noqa: E402

ATTN_ATOL = 2e-6
LOGIT_ATOL = 2e-5
MARGIN = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small CPU ops a test: run torch on one thread beside the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def _setup(arch, **kw):
    """(jcfg, cfg, JAX params as numpy, the port's tensors), cached."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _SETUPS:
        jcfg = jget_config(arch, smoke=True).replace(**kw)
        jp = jax.tree_util.tree_map(
            np.asarray, JR.init(jcfg, jax.random.PRNGKey(0)))
        _SETUPS[key] = (jcfg, get_config(arch, smoke=True).replace(**kw),
                        jp, interop.to_torch(jp, device="cpu"))
    return _SETUPS[key]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _qkv(seed, b, lq, lk, h, kh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, kh, d)).astype(np.float32),
            rng.standard_normal((b, lk, kh, d)).astype(np.float32))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_configs_mirror_jax(arch):
    """CONFIG and SMOKE field by field (JAX's ``remat`` aside, a memory
    policy with no knob in the port), and the run shapes."""
    for smoke in (False, True):
        j, t = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        for f in t.__dataclass_fields__:
            assert getattr(t, f) == getattr(j, f), f
    from repro.configs import shapes as JSH
    assert TSH.LM_SHAPE_NAMES == JSH.LM_SHAPE_NAMES
    for name, s in TSH.SHAPES.items():
        assert (s.seq_len, s.global_batch, s.mode, s.is_decode) == (
            JSH.SHAPES[name].seq_len, JSH.SHAPES[name].global_batch,
            JSH.SHAPES[name].mode, JSH.SHAPES[name].is_decode)


# ---------------------------------------------------------------------------
# the attention dataflows and the MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    # (b, lq, lk, h, kh, d, kw): GQA, MQA, windows, offsets, valid lengths,
    # several q and kv chunks with ragged last ones
    (2, 37, 37, 4, 2, 8, dict(causal=True, q_chunk=16, kv_chunk=8)),
    (1, 30, 30, 6, 1, 16, dict(causal=True, window=7, q_chunk=8,
                               kv_chunk=16)),
    (2, 5, 40, 4, 4, 8, dict(causal=True, q_offset=35, q_chunk=4,
                             kv_chunk=16)),
    (2, 9, 33, 8, 2, 8, dict(causal=False, kv_valid_len=21, q_chunk=4,
                             kv_chunk=8)),
    (1, 12, 12, 4, 2, 24, dict(causal=True, window=3)),
])
def test_flash_attention_matches_jax(case):
    b, lq, lk, h, kh, d, kw = case
    q, k, v = _qkv(lq + lk, b, lq, lk, h, kh, d)
    want = jax.jit(lambda q, k, v: jnn.flash_attention(q, k, v, **kw))(
        q, k, v)
    got = nn.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert got.shape == want.shape
    _close(got, want, ATTN_ATOL)


@pytest.mark.parametrize("case", [(2, 37, 4, 2, 8, 5, 8), (1, 40, 6, 1, 16,
                                                          16, 16),
                                  (2, 24, 4, 4, 8, 64, 8),
                                  (1, 9, 4, 2, 24, 3, 512),
                                  (2, 20, 4, 4, 8, 64, 8),
                                  (1, 42, 4, 2, 8, 37, 8)])
def test_banded_flash_attention_matches_jax(case):
    """Ragged last chunks, a band longer than the sequence, the band start
    clipped at both ends: equal to the masked flash attention with the
    window, and to JAX's banded attention wherever JAX's band (bounded by
    L, not the padded length) holds every key its chunk sees. The last
    two cases (window <= L < window + q_chunk or L <= window, L ragged)
    are where it does not: JAX drops keys there (ROADMAP queue 3), and
    its output differs from its own masked flash attention."""
    b, l, h, kh, d, window, q_chunk = case
    q, k, v = _qkv(l + window, b, l, l, h, kh, d)
    jband = jax.jit(lambda q, k, v: jnn.banded_flash_attention(
        q, k, v, window=window, q_chunk=q_chunk))(q, k, v)
    jflash = jax.jit(lambda q, k, v: jnn.flash_attention(
        q, k, v, window=window))(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = nn.banded_flash_attention(tq, tk, tv, window=window,
                                    q_chunk=q_chunk)
    _close(got, jflash, ATTN_ATOL)
    _close(got, nn.flash_attention(tq, tk, tv, window=window), ATTN_ATOL)
    lpad = -(-l // q_chunk) * q_chunk
    if lpad > l and l < window + q_chunk and l > q_chunk:
        assert np.abs(np.asarray(jband) - np.asarray(jflash)).max() > 0.01
    else:
        _close(got, jband, ATTN_ATOL)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_jax(window):
    """A ring of 12 entries per row with per-row tags (wrapped, partly
    empty), a bite of 3 queries a row at per-row positions, GQA."""
    b, lq, s, h, kh, d = 3, 3, 12, 4, 2, 8
    q, k, v = _qkv(s, b, lq, s, h, kh, d)
    pos = np.array([4, 15, 0], np.int32)
    entry = np.full((b, s), -1, np.int32)
    entry[0, :7] = np.arange(7)
    entry[1] = [12, 13, 14, 15, 16, 17, 6, 7, 8, 9, 10, 11]
    entry[2, 0] = 0
    want = jax.jit(lambda q, k, v, e, p: jnn.decode_attention(
        q, k, v, entry_pos=e, cur_pos=p, window=window))(q, k, v, entry, pos)
    got = nn.decode_attention(*map(torch.from_numpy, (q, k, v)),
                              entry_pos=torch.from_numpy(entry),
                              cur_pos=torch.from_numpy(pos), window=window)
    _close(got, want, ATTN_ATOL)


@pytest.mark.parametrize("case", [
    (2, 37, 37, 4, 2, 16, dict(causal=True, q_chunk=16, kv_chunk=8)),
    (2, 30, 30, 4, 1, 32, dict(causal=True, window=6, q_chunk=8,
                               kv_chunk=16)),
    (1, 6, 25, 4, 4, 16, dict(causal=True, q_offset=19, window=9)),
    (2, 9, 33, 4, 2, 16, dict(causal=False, kv_valid_len=20, q_chunk=4,
                              kv_chunk=8)),
])
@pytest.mark.parametrize("binarize", [True, False])
def test_binary_flash_attention_matches_jax(case, binarize):
    """Bitwise on {0,1} q / k / v with binarized scores (threshold ties
    included: delta sits on a count's score); analog scores within
    ATTN_ATOL times the largest context (the fp32 products sum in another
    order)."""
    b, lq, lk, h, kh, d, kw = case
    rng = np.random.default_rng(lq * lk)
    q, k, v = ((rng.random(s) < 0.5).astype(np.float32) for s in
               ((b, lq, h, d), (b, lk, kh, d), (b, lk, kh, d)))
    delta = np.float32(3 / np.sqrt(d))
    kw = dict(kw, binarize_scores=binarize)
    want = np.asarray(jax.jit(lambda q, k, v: jnn.binary_flash_attention(
        q, k, v, delta=delta, alpha=4.0, **kw))(q, k, v))
    got = nn.binary_flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    delta=float(delta), alpha=4.0,
                                    **kw).numpy()
    if binarize:
        np.testing.assert_array_equal(got, want)
        assert want.max() > 0
    else:
        _close(got, want, ATTN_ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_jax(act, gated):
    rng = np.random.default_rng(len(act) + gated)
    p = {"up": {"w": rng.standard_normal((24, 40)).astype(np.float32)},
         "down": {"w": rng.standard_normal((40, 24)).astype(np.float32)
                  * 0.2}}
    if gated:
        p["gate"] = {"w": rng.standard_normal((24, 40)).astype(np.float32)}
    x = rng.standard_normal((3, 7, 24)).astype(np.float32) * 0.5
    want = np.asarray(jax.jit(lambda p, x: jnn.mlp(p, x, act))(p, x))
    got = nn.mlp(interop.to_torch(p, device="cpu"), torch.from_numpy(x), act)
    _close(got, want, 1e-5 * np.abs(want).max())
    y = torch.linspace(-4, 4, 101)
    _close(nn.activation(act)(y),
           np.asarray(jnn.activation(act)(jnp.asarray(y.numpy()))), 1e-6)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_logits_match_jax(arch):
    """Prefill logits of 2 x 40 tokens (past h2o's and gemma3's SMOKE
    windows of 16 / 8, so the banded band slides), through
    ``build_prefill_step``; the tree's layout equals JAX's."""
    jcfg, cfg, jp, tp = _setup(arch)
    tok = _tokens(cfg, (2, 40), 1)
    want = np.asarray(jax.jit(jsteps.build_prefill_step(jcfg))(
        jp, {"tokens": tok}))
    got = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, LOGIT_ATOL)
    mine = TT.init(cfg, 3, device="cpu")
    assert jax.tree_util.tree_structure(jp) == \
        jax.tree_util.tree_structure(interop.to_numpy(mine))
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(interop.to_numpy(mine))):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma3-12b"])
@pytest.mark.parametrize("headroom", [0, 5])
def test_init_cache_rings_match_jax(arch, headroom):
    """Window rings of ``min(window + headroom, max_len)`` entries,
    full caches of max_len, B rows in the activation dtype, tags -1."""
    jcfg, cfg, _, _ = _setup(arch)
    for max_len in (12, 40):
        want = JR.init_cache(jcfg, 3, max_len, chunk_headroom=headroom)
        got = interop.to_numpy(registry.init_cache(
            cfg, 3, max_len, chunk_headroom=headroom, device="cpu"))
        assert jax.tree_util.tree_structure(want) == \
            jax.tree_util.tree_structure(got)
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)


def _decode_both(arch, bites, max_len, headroom=0, b=2, **kw):
    """Feed the same bites (pos, width, n_tok) through JAX's jitted and the
    port's decode_step from empty caches; per bite the logits within
    LOGIT_ATOL, tags equal, K / V within LOGIT_ATOL. Returns the port's
    logits of every bite and the prompt."""
    jcfg, cfg, jp, tp = _setup(arch, **kw)
    n = max(p + w for p, w, _ in bites)
    tok = _tokens(cfg, (b, n), 7)
    jcache = JR.init_cache(jcfg, b, max_len, chunk_headroom=headroom)
    cache = registry.init_cache(cfg, b, max_len, chunk_headroom=headroom,
                                device="cpu")
    jstep = jax.jit(lambda p, c, t, pos, nt: JR.decode_step(
        p, jcfg, c, t, pos, n_tok=nt))
    outs = []
    for p, w, n_tok in bites:
        t = tok[:, p:p + w]
        pos = np.full(b, p, np.int32)
        nt = np.asarray(n_tok, np.int32)
        jl, jcache = jstep(jp, jcache, t, pos, nt)
        tl, cache = registry.decode_step(tp, cfg, cache, torch.from_numpy(t),
                                         torch.from_numpy(pos),
                                         torch.from_numpy(nt))
        _close(tl, jl, LOGIT_ATOL)
        outs.append(tl)
    got = interop.to_numpy(cache)
    for path, want in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        if path[-1].key == "pos":
            np.testing.assert_array_equal(leaf, np.asarray(want))
        else:
            _close(leaf, want, LOGIT_ATOL)
    return outs, tok, cfg, tp


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_token_by_token_decode_matches_jax_and_prefill(arch):
    """20 single-token steps (past gemma3's window of 8, so its local
    rings wrap): against JAX's, and against the port's own prefill."""
    outs, tok, cfg, tp = _decode_both(arch, [(i, 1, [1, 1])
                                             for i in range(20)], 24)
    pre = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(tok)})
    _close(torch.cat(outs, dim=1), pre, LOGIT_ATOL)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma3-12b"])
def test_chunked_bites_past_the_window_match_jax(arch):
    """Bites of 8 over rings of window + 7 (h2o: window 16, ring 23;
    gemma3: window 8, ring 15), rows right-padded (n_tok below the width),
    positions past the ring length so it wraps mid-bite; then single
    tokens. Against JAX's and the port's own prefill."""
    bites = [(0, 8, [8, 8]), (8, 8, [8, 8]), (16, 8, [8, 8]),
             (24, 8, [8, 8]), (32, 8, [8, 8]), (40, 1, [1, 1]),
             (41, 1, [1, 1])]
    outs, tok, cfg, tp = _decode_both(arch, bites, 64, headroom=7)
    pre = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(tok)})
    _close(torch.cat(outs, dim=1), pre, LOGIT_ATOL)
    # a padded bite: row 1 takes 3 of 8 tokens, its padding unwritten
    _decode_both(arch, [(0, 8, [8, 3]), (8, 8, [8, 0])], 64, headroom=7)


def _serve(mod, cfg, params, reqs, *, slots, max_len, chunk):
    kw = {} if mod is JS else {"device": "cpu"}
    server = mod.BatchedServer(cfg, params, slots, max_len, chunk=chunk,
                               trace_logits=True, **kw)
    for rid, prompt, max_new in reqs:
        server.submit(mod.Request(rid=rid, prompt=prompt,
                                  max_new_tokens=max_new))
    server.run()
    assert len(server.completed) == len(reqs)
    return {r.rid: r for r in server.completed}, server


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma3-12b"])
def test_server_matches_jax_server(arch):
    """Staggered admission (three prompts over two slots, the third
    admitted mid-flight, prompts past the window) at a fixed chunk of 4:
    the same tokens as JAX's server wherever the port's top-2 margin
    clears MARGIN (up to the first such token, after which the prefixes
    may differ), logit rows within LOGIT_ATOL; the KV report equal."""
    jcfg, cfg, jp, tp = _setup(arch)
    reqs = [(0, _tokens(cfg, 21, 5), 4), (1, _tokens(cfg, 9, 6), 5),
            (2, _tokens(cfg, 18, 8), 3)]
    want, jserver = _serve(JS, jcfg, jp, reqs, slots=2, max_len=40, chunk=4)
    got, server = _serve(TS, cfg, tp, reqs, slots=2, max_len=40, chunk=4)
    assert server.waves == jserver.waves
    assert server.kv_cache_stats() == jserver.kv_cache_stats()
    for rid, *_ in reqs:
        for tg, tw, lg, lw in zip(got[rid].generated, want[rid].generated,
                                  got[rid].logit_trace,
                                  want[rid].logit_trace):
            _close(lg, lw, LOGIT_ATOL)
            top2 = np.sort(lg)[-2:]
            if top2[1] - top2[0] <= MARGIN:
                break
            assert tg == tw


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma3-12b"])
def test_train_step_matches_jax(arch):
    """One AdamW step on 2 x 12 tokens (past gemma3's window of 8):
    gradients (gemma3: the tied embedding takes both the lookup's and the
    head's), grad norm, loss and params against the jitted JAX step."""
    jcfg, cfg, jp, _ = _setup(arch)
    batch = {"tokens": _tokens(cfg, (2, 12), 9)}
    loss = check_train_step(jcfg, cfg, jp, None, batch)
    assert np.isfinite(loss) and loss > 0


def test_int8_dense_decode_matches_jax():
    """h2o-danube-3-4b with ``quantize_tree(..., 'int8')``: every linear
    through ``dense_quant_linear``, the decode logits against JAX's;
    gemma3's 4-D group weights stay unquantized in both packages."""
    from repro.quant import quantize_tree as jquantize_tree
    from repro_torch.quant import quantize_tree
    jcfg, cfg, jp, tp = _setup("h2o-danube-3-4b")
    jq = jax.tree_util.tree_map(np.asarray, jquantize_tree(jp, "int8"))
    tq = quantize_tree(tp, "int8")
    for a, b in zip(jax.tree_util.tree_leaves(jq),
                    jax.tree_util.tree_leaves(interop.to_numpy(tq))):
        np.testing.assert_array_equal(a, b)
    tok = _tokens(cfg, (2, 6), 3)
    jl, _ = jax.jit(lambda p, c, t: JR.decode_step(p, jcfg, c, t, 0))(
        jq, JR.init_cache(jcfg, 2, 8), tok)
    tl, _ = registry.decode_step(tq, cfg, registry.init_cache(
        cfg, 2, 8, device="cpu"), torch.from_numpy(tok), 0)
    _close(tl, jl, LOGIT_ATOL)
    g = quantize_tree(_setup("gemma3-12b")[3], "int8")
    assert "w" in g["groups"]["wq"] and "qw" not in g["groups"]["wq"]


@pytest.mark.parametrize("arch, quantize", [("h2o-danube-3-4b", "int8"),
                                            ("gemma3-12b", "none")])
def test_cli_serves_the_dense_smoke_models(arch, quantize, capsys):
    """``launch/serve.py --arch``: unpacked caches in the activation dtype
    (gemma3's local and global groups counted together), the int8 weight
    report on h2o-danube-3-4b, every request completed."""
    TS.main(["--arch", arch, "--smoke", "--device", "cpu", "--quantize",
             quantize, "--requests", "3", "--slots", "2", "--prompt-len",
             "20", "--max-new", "2", "--max-len", "24", "--chunk", "4"])
    out = capsys.readouterr().out
    assert "packed=False" in out and "3 requests, 6 generated" in out
    assert ("(int8)" in out) == (quantize == "int8")


def test_train_loop_runs_the_dense_family():
    """``launch/train.train`` on a dense SMOKE config: the token stream,
    AdamW, finite losses that fall over 12 steps."""
    from repro_torch.launch import train as TTrain
    losses = TTrain.train("gemma3-12b", True, 12, 4, 3e-3, device="cpu",
                          seq=16, log_every=100)
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
