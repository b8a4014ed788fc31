"""The port's vision-language family (``repro_torch.models.vlm``:
llava-next-mistral-7b, the mistral backbone behind stub patch
embeddings and the mm projector) against the JAX package at the SMOKE
size (fp32), on numpy-seeded inputs and JAX's own parameters
(``repro.models.registry.init`` through ``interop``).

Tolerances, and why:
* ``project_patches`` within REL = 1e-6 of its largest output: fp32
  products summed in another order, and the GELU's tanh (XLA's and
  torch's differ by an ulp);
* logits of forwards, decode steps and the server's logit rows within
  LOGIT_ATOL = 2e-5, ``test_torch_dense.py``'s tolerance (the backbone is
  the dense family's); the server's tokens equal wherever the top-2
  margin clears MARGIN = 1e-4;
* the banded attention at llava's window against the masked
  ``flash_attention`` within ATTN_ATOL = 2e-6, as in
  ``test_torch_dense.py``;
* one train step with ``tests/_torch_train_helpers.check_train_step``'s
  tolerances; int8 codes and scales bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import nn as JN  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import vlm as JV  # noqa: E402
from repro.quant import quantize_tree as jquantize_tree  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import vlm as TV  # noqa: E402
from repro_torch.quant import quantize_tree  # noqa: E402

from _torch_train_helpers import check_train_step, rel_close  # noqa: E402

ARCH = "llava-next-mistral-7b"
LOGIT_ATOL = 2e-5
ATTN_ATOL = 2e-6
MARGIN = 1e-4
REL = 1e-6


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


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _batch(cfg, b, s, seed):
    """Text tokens and stub patches of std 0.1 (JAX's test_models
    case)."""
    rng = np.random.default_rng(seed)
    fr = cfg.frontend
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "patch_embeds": rng.normal(0, 0.1, (b, fr.num_embeds,
                                                fr.embed_dim)).astype(
                np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def test_config_and_init_mirror_jax():
    """CONFIG and SMOKE field by field (the frontend config too), the arch
    in ``ALL_ARCHS``; the init tree (the backbone's and ``mm_projector``,
    a list of linears with biases) has JAX's layout, shapes and dtypes in
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
    assert isinstance(mine["mm_projector"], list)


def test_project_patches_matches_jax():
    jcfg, cfg, jp, tp = _setup()
    x = _batch(cfg, 2, 1, 3)["patch_embeds"]
    want = np.asarray(jax.jit(JV.project_patches)(jp, x))
    got = TV.project_patches(tp, torch.from_numpy(x))
    assert got.shape == (2, cfg.frontend.num_embeds, cfg.d_model)
    rel_close(got.numpy(), want, REL, "projected patches")


@pytest.mark.parametrize("s", [6, 12])
def test_forward_logits_match_jax(s):
    """8 patches + ``s`` text tokens (14: inside the window of 16; 20:
    past it) through ``build_prefill_step``; the loss skips the patch
    positions: the text tokens against the logits from the last patch on,
    equal to JAX's ``loss_from_forward``."""
    jcfg, cfg, jp, tp = _setup()
    batch = _batch(cfg, 2, s, 1)
    jl, _ = jax.jit(lambda p, b: JR.forward(p, jcfg, b))(jp, batch)
    got = steps.build_prefill_step(cfg, device="cpu")(tp, _tb(batch))
    assert got.shape == (2, cfg.frontend.num_embeds + s, cfg.vocab_size)
    _close(got, jl, LOGIT_ATOL)
    want = float(JST.loss_from_forward(jcfg, jl, batch))
    loss = float(steps.loss_from_forward(cfg, torch.from_numpy(
        np.array(jl)), _tb(batch)))
    assert loss == pytest.approx(want, rel=1e-6)


def test_banded_attention_at_llava_prompt_lengths():
    """A prompt of 2880 patches and 128 text tokens (3008 keys) at
    llava's window of 4096 and the banded attention's chunk of 512 lies
    where JAX's band, bounded by L and not the padded length, drops keys
    its last chunk sees (ROADMAP queue 3): JAX's banded output departs
    from its own masked flash attention, while the port's equals it (one
    head of 8, so the whole prompt stays small)."""
    rng = np.random.default_rng(7)
    l, window = 2880 + 128, 4096
    q, k, v = (rng.normal(0, 1, (1, l, 1, 8)).astype(np.float32)
               for _ in range(3))
    jband = np.asarray(jax.jit(lambda q, k, v: JN.banded_flash_attention(
        q, k, v, window=window))(q, k, v))
    jflash = np.asarray(jax.jit(lambda q, k, v: JN.flash_attention(
        q, k, v, window=window))(q, k, v))
    assert np.abs(jband - jflash).max() > 0.01
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(nn.banded_flash_attention(tq, tk, tv, window=window), jflash,
           ATTN_ATOL)


def test_text_decode_matches_jax_and_the_backbone():
    """20 text tokens decoded one a step (the text continuation after a
    multimodal prefill, through ``build_serve_step``) against JAX's vlm
    decode, the window ring wrapping past 16, and against the backbone's
    own forward on the same text."""
    jcfg, cfg, jp, tp = _setup()
    tok = _tokens(cfg, (2, 20), 1)
    jcache = JR.init_cache(jcfg, 2, 24)
    cache = registry.init_cache(cfg, 2, 24, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos: JR.decode_step(p, jcfg, c, t, pos))
    step = steps.build_serve_step(cfg, device="cpu")
    outs = []
    for i in range(20):
        jl, jcache = jstep(jp, jcache, tok[:, i:i + 1], i)
        tl, cache = step(tp, cache, torch.from_numpy(tok[:, i:i + 1]), i)
        _close(tl, jl, LOGIT_ATOL)
        outs.append(tl)
    pre, _ = TT.forward(tp, cfg, {"tokens": torch.from_numpy(tok)})
    _close(torch.cat(outs, dim=1), pre, LOGIT_ATOL)


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


def test_batched_server_matches_jax_and_sequential_decode():
    """Three text prompts over two slots (the third admitted mid-flight,
    prompts past the window of 16) at a fixed chunk of 4: the same tokens
    and logit rows as JAX's server, and each request's tokens equal to a
    sequential greedy decode of its prompt alone (single-row decode
    steps from an empty cache) wherever the margin clears."""
    jcfg, cfg, jp, tp = _setup()
    assert registry.supports_slots(cfg)
    reqs = [(0, _tokens(cfg, 21, 5), 4), (1, _tokens(cfg, 9, 6), 5),
            (2, _tokens(cfg, 18, 8), 3)]
    want, jserver = _serve(JS, jcfg, jp, reqs, slots=2, max_len=40, chunk=4)
    got, server = _serve(TSV, cfg, tp, reqs, slots=2, max_len=40, chunk=4)
    assert server.waves == jserver.waves
    step = steps.build_serve_step(cfg, device="cpu")
    for rid, prompt, max_new in reqs:
        for tg, tw, lg, lw in zip(got[rid].generated, want[rid].generated,
                                  got[rid].logit_trace,
                                  want[rid].logit_trace):
            _close(lg, lw, LOGIT_ATOL)
            top2 = np.sort(lg)[-2:]
            if top2[1] - top2[0] <= MARGIN:
                break
            assert tg == tw
        cache = registry.init_cache(cfg, 1, 40, device="cpu")
        seq, nxt = [], None
        for pos in range(len(prompt) + max_new - 1):
            t = prompt[pos] if pos < len(prompt) else nxt
            logits, cache = step(tp, cache, torch.tensor([[int(t)]]), pos)
            if pos >= len(prompt) - 1:
                nxt = int(logits[0, -1].argmax())
                seq.append((nxt, logits[0, -1].numpy()))
        for tg, (ts, ls) in zip(got[rid].generated, seq):
            top2 = np.sort(ls)[-2:]
            if top2[1] - top2[0] <= MARGIN:
                break
            assert tg == ts


def test_train_step_matches_jax():
    """One AdamW step of llava SMOKE on 8 stub patches + 2 x 10 text
    tokens against the jitted JAX step: the loss (text tokens only),
    gradients (the projector's too), grad norm, params."""
    jcfg, cfg, jp, _ = _setup()
    check_train_step(jcfg, cfg, jp, None, _batch(cfg, 2, 10, 9))


def test_quantize_tree_int8_leaves_match_jax():
    """``quantize_tree(..., 'int8')``: JAX's int8 leaves (the backbone's
    linears and both projector layers), codes and scales bitwise; the
    int8 forward within LOGIT_ATOL of JAX's."""
    jcfg, cfg, jp, tp = _setup()
    jq = jax.tree_util.tree_map(np.asarray, jquantize_tree(jp, "int8"))
    tq = interop.to_numpy(quantize_tree(tp, "int8"))
    assert jax.tree_util.tree_structure(jq) == \
        jax.tree_util.tree_structure(tq)
    paths = lambda t: sorted(jax.tree_util.keystr(p) for p, leaf in
                             jax.tree_util.tree_flatten_with_path(t)[0]
                             if leaf.dtype == np.int8)
    assert paths(tq) == paths(jq) and len(paths(tq)) == 10
    for a, b in zip(jax.tree_util.tree_leaves(jq),
                    jax.tree_util.tree_leaves(tq)):
        np.testing.assert_array_equal(a, b)
    batch = _batch(cfg, 2, 6, 4)
    jl, _ = jax.jit(lambda p, b: JR.forward(p, jcfg, b))(jq, batch)
    tl, _ = registry.forward(interop.to_torch(tq, device="cpu"), cfg,
                             _tb(batch))
    _close(tl, jl, LOGIT_ATOL)
