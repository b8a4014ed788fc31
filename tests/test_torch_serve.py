"""The port's continuous-batching server (``repro_torch.launch.serve``)
against the JAX package's unsharded ``BatchedServer``, at the SMOKE size
of spikingformer-lm (fp32 activations).

* ``choose_chunk`` and the decoder model's latency equal JAX's exactly;
* on the same params and requests, the port's server samples the same
  tokens as JAX's, with logit rows within 1e-5 (the analog projections
  sum in another order than XLA's dot; ``rmsnorm`` carries the rsqrt
  gap): staggered admission over two slots, and slot reuse;
* within the port, a request served alongside others or in a reused
  slot gives the tokens it gives alone and logits within 1e-5 (the CPU
  matmul's row sums depend on the wave's shape), and chunked prefill at
  every chunk width matches the prefill step's last-position logits
  within 2e-4 (JAX's own tolerance for this check);
* the KV-cache report, the request checks and the CLI.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.sim import decoder_sim as jdecoder_sim  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.sim import decoder_sim  # noqa: E402

ARCH = "spikingformer-lm"


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config(ARCH, smoke=True)
    jp = jax.tree_util.tree_map(np.asarray,
                                jregistry.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, get_config(ARCH, smoke=True), jp, \
        interop.to_torch(jp, device="cpu")


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                n).astype(np.int32)


def _serve(mod, cfg, params, reqs, *, slots, max_len=32, chunk=0):
    kw = {} if mod is JS else {"device": "cpu"}
    server = mod.BatchedServer(cfg, params, slots, max_len, chunk=chunk,
                               trace_logits=True, **kw)
    for rid, prompt, max_new in reqs:
        server.submit(mod.Request(rid=rid, prompt=prompt,
                                  max_new_tokens=max_new))
    server.run()
    assert len(server.completed) == len(reqs)
    return {r.rid: r for r in server.completed}, server


def test_choose_chunk_matches_jax():
    for remaining in (0, 1, 3, 17, 100, 513):
        for n_decoding in range(4):
            for max_chunk in (1, 4, 16, 64, 1024):
                assert TS.choose_chunk(remaining, n_decoding, max_chunk) == \
                    JS.choose_chunk(remaining, n_decoding, max_chunk)


def test_simulate_latency_matches_jax():
    rng = np.random.default_rng(0)
    for p_wo in (1, 2, 3):
        pc = rng.integers(0, 33, 200)
        assert decoder_sim.simulate_latency(
            pc, decoder_sim.DecoderConfig(32, 4, p_wo)) == \
            jdecoder_sim.simulate_latency(
                pc, jdecoder_sim.DecoderConfig(32, 4, p_wo))


@pytest.mark.parametrize("case", ["staggered", "slot_reuse"])
def test_server_matches_jax_server(setup, case):
    """Staggered admission (three prompts over two slots, the third
    admitted mid-flight) and slot reuse (two requests through one slot):
    the same tokens as JAX's server, logit rows within 1e-5; and each
    request's tokens equal to serving it alone, its logits within 1e-5
    (PyTorch's CPU matmul sums a row in an order that depends on the
    number of rows, which the wave's other slots change)."""
    jcfg, cfg, jp, tp = setup
    if case == "staggered":
        reqs = [(0, _prompt(cfg, 7, 5), 4), (1, _prompt(cfg, 4, 6), 6),
                (2, _prompt(cfg, 10, 7), 3)]
        slots = 2
    else:
        reqs = [(0, _prompt(cfg, 6, 1), 3), (1, _prompt(cfg, 9, 2), 5)]
        slots = 1
    want, _ = _serve(JS, jcfg, jp, reqs, slots=slots)
    got, server = _serve(TS, cfg, tp, reqs, slots=slots)
    assert server.waves > len(reqs)
    for rid, *_ in reqs:
        assert got[rid].generated == want[rid].generated
        for a, b in zip(got[rid].logit_trace, want[rid].logit_trace):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    for req in reqs:
        solo, _ = _serve(TS, cfg, tp, [req], slots=1)
        assert solo[req[0]].generated == got[req[0]].generated
        for a, b in zip(solo[req[0]].logit_trace, got[req[0]].logit_trace):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_chunked_prefill_matches_whole_prompt_prefill(setup):
    """The first sampled row (conditioned on the whole prompt) agrees
    with the prefill step's last-position logits for every chunk width,
    within 2e-4 (JAX's tolerance), and with JAX's prefill."""
    jcfg, cfg, jp, tp = setup
    prompt = _prompt(cfg, 11, 8)
    want = steps.build_prefill_step(cfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(prompt)[None]})[0, -1].numpy()
    jwant = np.asarray(jax.jit(JS.steps_lib.build_prefill_step(jcfg))(
        jp, {"tokens": prompt[None]}))[0, -1]
    np.testing.assert_allclose(want, jwant, rtol=0, atol=1e-5)
    for chunk in (1, 4, 16):
        got, _ = _serve(TS, cfg, tp, [(0, prompt, 2)], slots=1, chunk=chunk)
        np.testing.assert_allclose(got[0].logit_trace[0], want, atol=2e-4,
                                   rtol=2e-4)


def test_kv_stats_and_request_checks_match_jax(setup):
    jcfg, cfg, jp, tp = setup
    jserver = JS.BatchedServer(jcfg, jp, 2, 32)
    server = TS.BatchedServer(cfg, tp, 2, 32, device="cpu")
    assert server.kv_cache_stats() == jserver.kv_cache_stats()
    assert server.kv_cache_stats()["packed"]
    for bad in (np.zeros(0, np.int32), np.zeros(33, np.int32)):
        with pytest.raises(ValueError):
            server.submit(TS.Request(rid=0, prompt=bad, max_new_tokens=1))
    with pytest.raises(ValueError):
        server.submit(TS.Request(rid=0, prompt=_prompt(cfg, 3, 0),
                                 max_new_tokens=0))
    with pytest.raises(TypeError, match="Mesh"):
        TS.BatchedServer(cfg, tp, 2, 32, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="slotted"):
        TS.BatchedServer(get_config("spikingformer-4-256", smoke=True), tp,
                         2, 32, device="cpu")


def test_cli_serves_the_quantized_smoke_model(capsys):
    TS.main(["--smoke", "--device", "cpu", "--quantize", "int4",
             "--requests", "3", "--slots", "2", "--prompt-len", "5",
             "--max-new", "2", "--max-len", "16"])
    out = capsys.readouterr().out
    assert "kv cache" in out and "packed=True" in out
    assert "(int4)" in out and "3 requests, 6 generated" in out
    with pytest.raises(ValueError, match="DATAxMODEL"):
        TS.main(["--smoke", "--device", "cpu", "--mesh", "2by2"])
