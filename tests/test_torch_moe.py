"""The port's MoE family (``repro_torch.models.moe``: deepseek-moe-16b,
kimi-k2-1t-a32b) against the JAX package at the SMOKE size (fp32), on
numpy-seeded inputs and JAX's own parameters
(``repro.models.registry.init`` through ``interop``).

Tolerances, and why:
* ``router_topk``: expert ids equal on every token whose K-th and
  (K+1)-th probabilities differ by more than MARGIN = 1e-5 (the fp32
  router logits sum in another order, so a nearer tie may flip); on
  exact ties equal everywhere (the lower id first, as ``lax.top_k``);
  weights, ``aux_lb`` and ``aux_z`` within 1e-6 (torch's ``exp`` and
  XLA's differ by an ulp or two);
* ``_dispatch_local`` with a stand-in expert FFN that scales each
  expert's tokens (one rounding, the same on both sides) bitwise: the
  port's combine adds each token's weighted expert outputs in JAX's
  scatter order; with the real FFN within 1e-5 of the largest output
  (the expert products sum in another order, silu carries an ulp);
* logits of whole forwards and decode steps within LOGIT_ATOL = 2e-5,
  ``test_torch_dense.py``'s tolerance (rmsnorm's rsqrt, the softmax
  attention and the projections' sums round apart from XLA's, through 3
  layers); ``moe_aux`` within 1e-6 relative;
* the spiking forward as ``test_torch_window.py`` holds the spiking
  LM's: the spikes, and so the binary attention's integer counts, agree
  exactly, and the logits within the same 2e-5 (here also the routed
  FFNs, which see every timestep's tokens);
* one train step with ``tests/_torch_train_helpers.check_train_step``'s
  tolerances (the token family's loss, here with the router losses,
  within ``DENSE_LOSS_REL``);
* int8 codes and scales bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.spiking import SpikingConfig as JSpikingConfig  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.quant import quantize_tree as jquantize_tree  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import MOE_ARCHS, get_config  # noqa: E402
from repro_torch.core.spiking import SpikingConfig  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.quant import fake_quant_tree, quantize_tree  # noqa: E402

from _torch_train_helpers import check_train_step, rel_close  # noqa: E402

LOGIT_ATOL = 2e-5
MARGIN = 1e-5
DEEPSEEK = "deepseek-moe-16b"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small CPU ops a test: run torch on one thread beside the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def _setup(arch, spiking_t=None, **moe):
    """(jcfg, cfg, JAX params as numpy, the port's tensors), cached;
    ``spiking_t``: the config in spiking mode with T = spiking_t; ``moe``
    overrides fields of the MoE config."""
    key = (arch, spiking_t, tuple(sorted(moe.items())))
    if key not in _SETUPS:
        jcfg, cfg = jget_config(arch, smoke=True), get_config(arch,
                                                               smoke=True)
        if moe:
            jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe))
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
        if spiking_t is not None:
            jcfg = jcfg.replace(spiking=JSpikingConfig(time_steps=spiking_t))
            cfg = cfg.replace(spiking=SpikingConfig(time_steps=spiking_t))
        jp = jax.tree_util.tree_map(
            np.asarray, JR.init(jcfg, jax.random.PRNGKey(0)))
        _SETUPS[key] = (jcfg, cfg, jp, interop.to_torch(jp, device="cpu"))
    return _SETUPS[key]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_and_init_mirror_jax(arch):
    """CONFIG and SMOKE field by field (the MoE config too; JAX's
    ``remat`` aside), the arch listed for ``launch/train.py``; the port's
    init tree has JAX's layout, shapes and dtypes (the router fp32 in a
    bf16 model)."""
    from repro_torch.configs import ALL_ARCHS
    assert arch in ALL_ARCHS
    for smoke in (False, True):
        j, t = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        for f in t.__dataclass_fields__:
            if f == "moe":
                assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
            else:
                assert getattr(t, f) == getattr(j, f), f
    jcfg, cfg, jp, _ = _setup(arch)
    for jc, tc in ((jcfg, cfg), (jcfg.replace(dtype="bfloat16"),
                                 cfg.replace(dtype="bfloat16"))):
        want = jax.eval_shape(lambda: JR.init(jc, jax.random.PRNGKey(0)))
        mine = interop.to_numpy(registry.init(tc, 3, device="cpu"))
        assert jax.tree_util.tree_structure(want) == \
            jax.tree_util.tree_structure(mine)
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(mine)):
            assert a.shape == b.shape and a.dtype == b.dtype
        assert mine["layers"]["moe"]["router"].dtype == np.float32


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------


def test_router_topk_matches_jax():
    """On 300 random tokens (kimi SMOKE's 16 experts, top-4) ids equal
    where the margin clears MARGIN, weights and both losses within 1e-6;
    on a router with duplicated columns (exact ties) ids equal everywhere,
    the lower id first."""
    m = get_config("kimi-k2-1t-a32b", smoke=True).moe
    jm = jget_config("kimi-k2-1t-a32b", smoke=True).moe
    rng = np.random.default_rng(11)
    x = rng.standard_normal((300, 96)).astype(np.float32)
    r = (rng.standard_normal((96, m.num_experts)) / 10).astype(np.float32)
    tied = r.copy()
    tied[:, 1::2] = tied[:, 0::2]           # each odd column ties its left
    for router, everywhere in ((r, False), (tied, True)):
        jw, jidx, jlb, jz = jax.jit(lambda x, r: JM.router_topk(x, r, jm))(
            x, router)
        w, idx, lb, z = TM.router_topk(torch.from_numpy(x),
                                       torch.from_numpy(router), m)
        probs = np.sort(np.asarray(jax.nn.softmax(
            jnp.asarray(x) @ router, axis=-1)), axis=-1)[:, ::-1]
        clear = (probs[:, m.top_k - 1] - probs[:, m.top_k] > MARGIN) \
            | everywhere
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(idx.numpy()[clear],
                                      np.asarray(jidx)[clear])
        _close(w, jw, 1e-6)
        rel_close(float(lb), float(jlb), 1e-6, "aux_lb")
        rel_close(float(z), float(jz), 1e-6, "aux_z")
    # each tied pair (2i, 2i + 1) is chosen together, its lower id first
    ids = idx.numpy()
    assert (ids[:, 0::2] % 2 == 0).all()
    np.testing.assert_array_equal(ids[:, 1::2], ids[:, 0::2] + 1)


def _stand_in_ffn(xg, up, gate, down, act):
    """Each expert's tokens scaled by its up[:, 0, 0]: one rounding,
    the same in both packages."""
    return xg * up[:, :1, :1]


@pytest.mark.parametrize("case", [
    dict(cf=8.0, e_local=None, offset=0),      # every choice has a slot
    dict(cf=0.5, e_local=None, offset=0),      # overflow: choices dropped
    dict(cf=1.25, e_local="half", offset="half"),   # the upper expert half
])
def test_dispatch_local_matches_jax(case, monkeypatch):
    """``_dispatch_local`` on JAX's ``w`` / ``idx`` (deepseek SMOKE's 8
    experts, top-2, 40 tokens): with the real expert FFN within 1e-5 of
    the largest output; with a stand-in FFN bitwise, so the combine sums
    each token's outputs in the order of JAX's scatter-add."""
    jcfg, cfg, jp, tp = _setup(DEEPSEEK)
    m = dataclasses.replace(cfg.moe, capacity_factor=case["cf"])
    jm = dataclasses.replace(jcfg.moe, capacity_factor=case["cf"])
    e = m.num_experts
    e_local = e // 2 if case["e_local"] == "half" else e
    offset = e // 2 if case["offset"] == "half" else 0
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, cfg.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    w, idx, _, _ = JM.router_topk(x, lp["router"], jm)
    w, idx = np.array(w), np.array(idx)
    experts = [lp[n][offset:offset + e_local] for n in ("up", "gate", "down")]
    args = (jm, "silu", e_local, offset)
    for ffn in (None, _stand_in_ffn):
        if ffn is not None:
            monkeypatch.setattr(JM, "_local_expert_ffn", ffn)
            monkeypatch.setattr(TM, "_local_expert_ffn", ffn)
        want = np.asarray(jax.jit(lambda x, w, i, *ex: JM._dispatch_local(
            x, w, i, *ex, *args))(x, w, idx, *experts))
        got = TM._dispatch_local(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(idx),
            *map(torch.from_numpy, experts), m, "silu", e_local,
            offset).numpy()
        if ffn is None:
            _close(got, want, 1e-5 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want)
    # the case's point: an expert over its capacity, tokens with no local
    # choice, or every choice held
    cap = int(np.ceil(x.shape[0] * m.top_k / e * case["cf"]))
    counts = np.bincount(idx.reshape(-1), minlength=e)
    local = (idx >= offset) & (idx < offset + e_local)
    if case["cf"] < 1:
        assert counts.max() > cap
    elif e_local < e:
        assert (~local.any(-1)).any() and local.any(-1).any()
        np.testing.assert_array_equal(got[~local.any(-1)], 0.0)
    else:
        assert counts.max() <= cap


def test_moe_ffn_with_shared_experts_matches_jax():
    """``moe_ffn`` on (2, 9, D) inputs of each arch's first MoE layer: the
    routed experts plus the shared ones, and the layer's aux loss."""
    for arch in MOE_ARCHS:
        jcfg, cfg, jp, tp = _setup(arch)
        x = np.random.default_rng(6).standard_normal(
            (2, 9, cfg.d_model)).astype(np.float32)
        jy, jaux = jax.jit(lambda p, x: JM.moe_ffn(p, x, jcfg))(
            jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"]), x)
        y, aux = TM.moe_ffn(TM._stack_layer(tp["layers"]["moe"], 0),
                            torch.from_numpy(x), cfg)
        assert "shared" in tp["layers"]["moe"]
        _close(y, jy, 1e-5 * np.abs(np.asarray(jy)).max())
        rel_close(float(aux), float(jaux), 1e-6, "aux")


# ---------------------------------------------------------------------------
# forward, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch, spiking_t", [(a, None) for a in MOE_ARCHS]
                         + [(DEEPSEEK, 2)])
def test_forward_logits_and_aux_match_jax(arch, spiking_t):
    """2 x 12 tokens through ``build_prefill_step`` (logits) and
    ``registry.forward`` (``moe_aux``); the spiking deepseek (T = 2) runs
    the binary engine's attention and its FFNs on every timestep's
    tokens. ``inputs_embeds`` in place of the lookup gives the same."""
    jcfg, cfg, jp, tp = _setup(arch, spiking_t)
    tok = _tokens(cfg, (2, 12), 1)
    jl, jaux = jax.jit(lambda p, t: JR.forward(p, jcfg, {"tokens": t}))(
        jp, tok)
    got = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float32 and got.shape == jl.shape
    _close(got, jl, LOGIT_ATOL)
    logits, aux = registry.forward(tp, cfg, {"tokens": torch.from_numpy(tok)})
    assert torch.equal(logits, got)
    rel_close(float(aux["moe_aux"]), float(jaux["moe_aux"]), 1e-6, "moe_aux")
    embeds = tp["embed"]["table"][torch.from_numpy(tok).long()]
    again, _ = TM.forward(tp, cfg, {"tokens": torch.from_numpy(tok)},
                          inputs_embeds=embeds)
    assert torch.equal(again, logits)


@pytest.mark.parametrize("arch, cf", [(DEEPSEEK, 8.0), (DEEPSEEK, 1.25),
                                      ("kimi-k2-1t-a32b", 8.0)])
def test_token_by_token_decode_matches_jax(arch, cf):
    """10 single-token steps of 4 rows through ``build_serve_step`` against
    JAX's decode (logits within LOGIT_ATOL, the cache's tags equal, K / V
    within LOGIT_ATOL). At SMOKE's capacity factor 8.0 nothing is dropped
    and the steps also equal the forward; at the published 1.25 a step's
    capacity is 1 (4 tokens, top-2 of 8), its colliding choices drop in
    both packages alike, and the steps differ from the forward."""
    jcfg, cfg, jp, tp = _setup(arch, capacity_factor=cf)
    b, n = 4, 10
    tok = _tokens(cfg, (b, n), 7)
    jcache = JR.init_cache(jcfg, b, 12)
    cache = registry.init_cache(cfg, b, 12, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos: JR.decode_step(p, jcfg, c, t, pos))
    step = steps.build_serve_step(cfg, device="cpu")
    outs = []
    for i in range(n):
        jl, jcache = jstep(jp, jcache, tok[:, i:i + 1], i)
        tl, cache = step(tp, cache, torch.from_numpy(tok[:, i:i + 1]), i)
        _close(tl, jl, LOGIT_ATOL)
        outs.append(tl)
    got = interop.to_numpy(cache)
    for group in jcache:
        np.testing.assert_array_equal(got[group]["pos"],
                                      np.asarray(jcache[group]["pos"]))
        for kv in ("k", "v"):
            _close(got[group][kv], jcache[group][kv], LOGIT_ATOL)
    pre = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(tok)})
    diff = float((torch.cat(outs, dim=1) - pre).abs().max())
    if cf == 8.0:
        assert diff <= LOGIT_ATOL
    else:
        assert diff > 0.05


def test_spiking_decode_raises_in_both_packages():
    """The reference's spiking MoE decode fails (its cache holds T*B rows,
    its step neither broadcasts over T nor spikes); the port refuses it
    with a ValueError naming ROADMAP queue 3. Its cache mirrors JAX's
    (T*B rows). A chunked-prefill ``n_tok`` is refused too, as JAX's
    signature refuses it."""
    jcfg, cfg, jp, tp = _setup(DEEPSEEK, 2)
    tok = _tokens(cfg, (2, 1), 3)
    with pytest.raises(ValueError):
        JR.decode_step(jp, jcfg, JR.init_cache(jcfg, 2, 8), tok, 0)
    cache = registry.init_cache(cfg, 2, 8, device="cpu")
    assert cache["layers"]["k"].shape[1] == 4
    with pytest.raises(ValueError, match="ROADMAP queue 3"):
        registry.decode_step(tp, cfg, cache, torch.from_numpy(tok), 0)
    with pytest.raises(TypeError):
        JM.decode_step(jp, jcfg, JR.init_cache(jcfg, 2, 8), tok, 0,
                       n_tok=np.ones(2, np.int32))
    dense = _setup(DEEPSEEK)
    with pytest.raises(TypeError, match="n_tok"):
        registry.decode_step(dense[3], dense[1], registry.init_cache(
            dense[1], 2, 8, device="cpu"), torch.from_numpy(tok), 0,
            n_tok=torch.ones(2))


# ---------------------------------------------------------------------------
# training, quantization, serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qat", [None, "int8"])
def test_train_step_matches_jax(qat):
    """One AdamW step of deepseek SMOKE on 2 x 10 tokens, plain and with
    ``qat='int8'`` (the expert stacks and the router stay fp in both),
    against the jitted JAX step: the loss with the router losses,
    gradients, grad norm, params; the metrics' ``moe_aux`` is the
    forward's."""
    jcfg, cfg, jp, tp = _setup(DEEPSEEK)
    batch = {"tokens": _tokens(cfg, (2, 10), 9)}
    loss = check_train_step(jcfg, cfg, jp, None, batch, qat=qat)
    opt = adamw(1e-3)
    _, _, _, m = steps.build_train_step(cfg, opt, qat=qat, device="cpu")(
        tp, opt.init(tp), 0, batch)
    assert float(m["loss"]) == loss and "moe_aux" in m
    fq = tp if qat is None else fake_quant_tree(tp, qat)
    _, aux = registry.forward(fq, cfg, {"tokens": torch.from_numpy(
        batch["tokens"])}, train=True)
    assert float(m["moe_aux"]) == float(aux["moe_aux"]) > 0
    if qat is not None:
        assert torch.equal(fq["layers"]["moe"]["up"],
                           tp["layers"]["moe"]["up"])
        assert not torch.equal(fq["layers"]["wq"]["w"],
                               tp["layers"]["wq"]["w"])


def test_quantize_tree_int8_leaves_match_jax():
    """``quantize_tree(..., 'int8')``: JAX's 15 int8 leaves (q / k / v / wo
    of both stacks, the dense MLP, the shared experts, ``lm_head``), codes
    and scales bitwise; the 4-D expert stacks and the router stay fp; the
    int8 forward within LOGIT_ATOL of JAX's."""
    jcfg, cfg, jp, tp = _setup(DEEPSEEK)
    jq = jax.tree_util.tree_map(np.asarray, jquantize_tree(jp, "int8"))
    tq = interop.to_numpy(quantize_tree(tp, "int8"))
    assert jax.tree_util.tree_structure(jq) == \
        jax.tree_util.tree_structure(tq)
    paths = lambda t: sorted(jax.tree_util.keystr(p) for p, leaf in
                             jax.tree_util.tree_flatten_with_path(t)[0]
                             if leaf.dtype == np.int8)
    assert paths(tq) == paths(jq) and len(paths(tq)) == 15
    for a, b in zip(jax.tree_util.tree_leaves(jq),
                    jax.tree_util.tree_leaves(tq)):
        np.testing.assert_array_equal(a, b)
    assert tq["layers"]["moe"]["up"].dtype == np.float32
    tok = _tokens(cfg, (2, 8), 4)
    jl, _ = jax.jit(lambda p, t: JR.forward(p, jcfg, {"tokens": t}))(jq, tok)
    tl, _ = registry.forward(interop.to_torch(tq, device="cpu"), cfg,
                             {"tokens": torch.from_numpy(tok)})
    _close(tl, jl, LOGIT_ATOL)


def test_batched_server_refuses_moe_as_jax():
    """No per-slot decode state: ``BatchedServer`` refuses the family in
    both packages; the serve CLI's arch list carries it all the same."""
    from repro.launch import serve as JS
    jcfg, cfg, jp, tp = _setup(DEEPSEEK)
    assert not registry.supports_slots(cfg) and registry.has_decode(cfg)
    with pytest.raises(ValueError, match="slotted-decode"):
        JS.BatchedServer(jcfg, jp, 2, 16)
    with pytest.raises(ValueError, match="slotted-decode"):
        TS.BatchedServer(cfg, tp, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="chunked-prefill"):
        registry.init_cache(cfg, 2, 16, chunk_headroom=3, device="cpu")


def test_train_loop_runs_and_logs_moe_aux(capsys):
    """``launch/train.train`` on deepseek SMOKE: the token stream, AdamW,
    finite losses, ``moe_aux`` in each logged line."""
    from repro_torch.launch import train as TTrain
    losses = TTrain.train(DEEPSEEK, True, 6, 2, 3e-3, device="cpu", seq=16,
                          log_every=2)
    assert len(losses) == 6 and all(np.isfinite(losses))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[train] step")]
    assert lines and all(" moe_aux=" in ln for ln in lines)
