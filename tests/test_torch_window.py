"""The spiking LM's sliding-window (``attn_type='swa'``) and local/global
attention (``repro_torch.models.transformer`` with ``spiking``) against
the JAX package at spikingformer-lm's SMOKE size (fp32 activations,
window 5, ``global_every`` 2), on numpy-seeded tokens and JAX's own
parameters (``repro.models.registry.init`` through ``interop``).

Tolerances, and why:
* ``_attend_full_seq`` on {0,1} spikes bitwise, window and full: integer
  counts, the threshold as the FMA jitted XLA contracts it into
  (``nn.fma32``), integer context sums;
* logits of forwards, decode bites and server rows within 1e-5 absolute,
  ``test_torch_lm.py``'s tolerance for the spiking LM: rmsnorm's rsqrt
  and the analog projections round apart from XLA's (ROADMAP queue 3),
  while the spikes, and so the attention, agree exactly;
* the packed caches' words and validity tags equal, bit for bit;
* the int8 tree (global layers through the layer program's plain
  version, window layers through the banded dataflow) within the same
  1e-5, as ``test_torch_lm.py`` holds the full-attention int8 LM.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.quant import quantize_tree as jquantize_tree  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = "spikingformer-lm"
ATOL = 1e-5
KINDS = {"swa": dict(attn_type="swa", window=5),
         "local_global": dict(attn_type="local_global", window=5,
                              global_every=2)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small CPU ops a test: run torch on one thread beside the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def _setup(kind, weights="fp32"):
    """(jcfg, cfg, JAX params as numpy, the port's tensors), cached."""
    if (kind, weights) not in _SETUPS:
        jcfg = jget_config(ARCH, smoke=True).replace(**KINDS[kind])
        cfg = get_config(ARCH, smoke=True).replace(**KINDS[kind])
        jp = jax.tree_util.tree_map(
            np.asarray, JR.init(jcfg, jax.random.PRNGKey(0)))
        if weights != "fp32":
            jp = jax.tree_util.tree_map(np.asarray,
                                        jquantize_tree(jp, weights))
            jcfg = jcfg.replace(engine=jcfg.engine.replace(weights=weights))
            cfg = cfg.replace(engine=cfg.engine.replace(weights=weights))
        _SETUPS[kind, weights] = (jcfg, cfg, jp,
                                  interop.to_torch(jp, device="cpu"))
    return _SETUPS[kind, weights]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("attn", ["window", "full"])
def test_attend_full_seq_matches_jax_bitwise(attn):
    """The spiking attention of a layer on {0,1} q / k / v (T*B = 4 rows,
    S = 23, 4 heads of 16): the window branch (``binary_flash_attention``
    with the window) and the full one (the binary engine's dispatch)."""
    jcfg, cfg, jp, _ = _setup("swa")
    rng = np.random.default_rng(len(attn))
    q, k, v = ((rng.random((4, 23, 4, 16)) < 0.4).astype(np.float32)
               for _ in range(3))
    delta = np.float32(0.7)
    want = np.asarray(jax.jit(lambda q, k, v: JT._attend_full_seq(
        jcfg, attn, q, k, v, delta=delta))(q, k, v))
    got = TT._attend_full_seq(cfg, attn, *map(torch.from_numpy, (q, k, v)),
                              delta=torch.tensor(delta))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 0


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_forward_logits_match_jax(kind, weights):
    """The SMOKE prefill (2 x 14 tokens, past the window of 5) through
    ``build_prefill_step``; the tree's layout equals JAX's (no ``delta``
    leaf is missing, ``groups`` on two leading axes)."""
    jcfg, cfg, jp, tp = _setup(kind, weights)
    tok = _tokens(cfg, (2, 14), 1)
    want = np.asarray(jax.jit(jsteps.build_prefill_step(jcfg))(
        jp, {"tokens": tok}))
    got = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float32 and want.std() > 0
    _close(got, want)
    mine = interop.to_numpy(TT.init(cfg, 3, device="cpu"))
    ref = jax.tree_util.tree_map(
        np.asarray, JR.init(jcfg, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(mine)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(mine)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("kind", list(KINDS))
def test_init_cache_rings_match_jax(kind):
    """Packed spike rings of ``min(window + headroom, max_len)`` entries
    (T*B rows, one word a row of 16 channels), full caches of max_len,
    tags -1; int32 words with JAX's uint32 patterns."""
    jcfg, cfg, _, _ = _setup(kind)
    for max_len, headroom in ((4, 0), (16, 0), (16, 3)):
        want = JR.init_cache(jcfg, 3, max_len, chunk_headroom=headroom)
        got = registry.init_cache(cfg, 3, max_len, chunk_headroom=headroom,
                                  device="cpu")
        assert set(got) == set(want)
        for group in want:
            for key in ("k", "v", "pos"):
                g, w = got[group][key], np.asarray(want[group][key])
                assert tuple(g.shape) == w.shape
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), w.view(np.int32))


@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_bites_match_jax_and_prefill(kind):
    """Single tokens, then bites of 4 (rows right-padded) over rings of
    window + 3 = 8 entries, wrapping mid-bite, through JAX's jitted and
    the port's batched serve step from empty caches: logits within ATOL,
    every cache word and tag equal; the bites' logits against the port's
    own prefill within ATOL."""
    jcfg, cfg, jp, tp = _setup(kind)
    b = 2
    tok = _tokens(cfg, (b, 22), 2)
    jstep = jax.jit(jsteps.build_batched_serve_step(jcfg))
    tstep = steps.build_batched_serve_step(cfg, device="cpu")
    jcache = JR.init_cache(jcfg, b, 24, chunk_headroom=3)
    cache = registry.init_cache(cfg, b, 24, chunk_headroom=3, device="cpu")
    bites = [(0, 1, [1, 1]), (1, 1, [1, 1]), (2, 4, [4, 4]),
             (6, 4, [4, 4]), (10, 4, [4, 4]), (14, 4, [4, 4]),
             (18, 4, [4, 2])]
    outs = []
    for p, w, n in bites:
        t = tok[:, p:p + w]
        pos = np.full(b, p, np.int32)
        n_tok = np.asarray(n, np.int32)
        want, jcache = jstep(jp, jcache, t, pos, n_tok)
        got, cache = tstep(tp, cache, torch.from_numpy(t),
                           torch.from_numpy(pos), torch.from_numpy(n_tok))
        _close(got, want)
        outs.append(got)
    for group in cache:
        for key in ("k", "v", "pos"):
            np.testing.assert_array_equal(
                cache[group][key].numpy(),
                np.asarray(jcache[group][key]).view(np.int32))
    pre = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(tok[:, :22])})
    _close(torch.cat(outs, dim=1)[:, :20], pre[:, :20])
    _close(outs[-1][0], pre[0, 18:22])


@pytest.mark.parametrize("kind", list(KINDS))
def test_server_matches_jax_server(kind):
    """Staggered admission (three prompts over two slots, the third
    admitted mid-flight, two prompts past the window) under the chunk
    policy: the same tokens as JAX's server, logit rows within ATOL, the
    packed KV report equal."""
    jcfg, cfg, jp, tp = _setup(kind)
    reqs = [(0, _tokens(cfg, 11, 5), 4), (1, _tokens(cfg, 4, 6), 5),
            (2, _tokens(cfg, 9, 7), 3)]

    def serve(mod, c, params):
        kw = {} if mod is JS else {"device": "cpu"}
        server = mod.BatchedServer(c, params, 2, 24, trace_logits=True,
                                   **kw)
        for rid, prompt, max_new in reqs:
            server.submit(mod.Request(rid=rid, prompt=prompt,
                                      max_new_tokens=max_new))
        server.run()
        return {r.rid: r for r in server.completed}, server
    want, jserver = serve(JS, jcfg, jp)
    got, server = serve(TS, cfg, tp)
    assert server.waves == jserver.waves
    assert server.kv_cache_stats() == jserver.kv_cache_stats()
    assert server.headroom == jserver.headroom > 0
    for rid, *_ in reqs:
        assert got[rid].generated == want[rid].generated
        for a, b in zip(got[rid].logit_trace, want[rid].logit_trace):
            _close(a, b)
