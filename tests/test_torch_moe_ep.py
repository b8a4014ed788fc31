"""The port's expert-parallel MoE (``models.moe.use_ep_mesh`` over gloo
ranks on the CPU) against JAX's ``use_ep_mesh`` (``shard_map`` over 4
forced host devices, in a subprocess as ``tests/test_serve.py`` runs its
mesh script), deepseek-moe-16b SMOKE (fp32) on JAX's params, meshes
(data, model) = (1, 2) and (2, 2), token axes ('data',), at capacity
factors 8.0 (nothing drops) and 1.25 (the published factor: a rank's
capacity follows its own tokens, as inside JAX's shard_map).

Bound, and why: the logits of the forward and of each token-by-token
decode step within LOGIT_ATOL = 2e-5, ``test_torch_moe.py``'s bound for
the unsharded family (the projections, rmsnorm's rsqrt and the softmax
attention round apart from XLA's through 3 layers; both packages sum the
two ranks' fp32 combines in the same order); ``moe_aux`` within 1e-6
relative, as there. The bf16 model's forward at capacity 8.0, where
each rank's combine is rounded to bf16 and the ranks' sum taken in bf16,
within BF16_ATOL = 2^-3 of JAX's: four bf16 ulps of the SMOKE logits
(|logit| < 8, ulp 2^-5), the size at which the port's and XLA's bf16
models already part unsharded (each projection's fp32 sum, taken in
another order, now and then rounds to the neighbouring bf16 value; 0.074
measured), far below the 0.70 by which JAX's EP and unsharded bf16
logits part. At capacity 1.25 such a neighbouring value can move a token
over its expert's capacity, which drops its whole expert output, so the
bf16 case holds 8.0 only; the fp32 cases hold 1.25. JAX's jitted EP decode fails under the installed jax
(ROADMAP queue 3): the decode steps are held against JAX's unsharded
decode of each data rank's rows, which is what EP decode computes.
Also: the spiking SMOKE prefill (T = 2; on (2, 2) each data rank takes
one timestep) under EP against the port's unsharded one within the same
bound, and a rank that draws its params through
``ep_keep`` holds only its slices and computes the same logits.

The whole model sharded (``moe.mesh_specs``, ``_MOE``'s table: attention
heads, the dense layer's and the shared experts' d_ff and the vocab over
'model', FSDP over 'data', the routed experts over 'model') on JAX's
params through ``shard_put``, under a ``MeshScope`` and ``use_ep_mesh``:
forward and decode within LOGIT_ATOL of JAX's EP run, the bf16 forward
within BF16_ATOL, each rank's bytes its specs' share."""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import registry as JR  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

import _torch_mesh_ranks as R  # noqa: E402

LOGIT_ATOL = 2e-5
BF16_ATOL = 2.0 ** -3
AUX_REL = 1e-6
MESHES = ((1, 2), (2, 2))
CFS = (8.0, 1.25)
B, S, N_DECODE = 4, 8, 3
SPIKING_T = 2

_SCRIPT = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax, numpy as np
    from repro.configs import get_config
    from repro.models import moe as JM, registry as JR
    assert len(jax.devices()) == 4
    tok = np.load(sys.argv[1])["tokens"]
    out = {{}}

    def decode(cfg, params, tok):
        cache = JR.init_cache(cfg, tok.shape[0], {n})
        step = jax.jit(lambda p, c, t, i: JR.decode_step(p, cfg, c, t, i))
        dec = []
        for i in range({n}):
            dl, cache = step(params, cache, tok[:, i:i + 1], i)
            dec.append(np.asarray(dl))
        return np.concatenate(dec, axis=1)
    for cf in {cfs}:
        cfg = get_config("deepseek-moe-16b", smoke=True)
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf))
        params = JR.init(cfg, jax.random.PRNGKey(0))
        for shape in {meshes}:
            mesh = jax.make_mesh(shape, ("data", "model"))
            key = f"{{cf}}-{{shape[0]}}x{{shape[1]}}"
            with JM.use_ep_mesh(mesh, token_axes=("data",)):
                lg, aux = jax.jit(lambda p, t: JR.forward(
                    p, cfg, {{"tokens": t}}))(params, tok)
                try:
                    out[key + "-decode"] = decode(cfg, params, tok)
                except Exception as e:
                    out[key + "-decode-error"] = np.asarray(type(e).__name__)
            out[key + "-logits"] = np.asarray(lg)
            out[key + "-aux"] = np.asarray(aux["moe_aux"])
            # what EP decode computes: each data rank's rows on their own
            # (routing capacity from the rank's tokens)
            rows = np.split(np.arange(tok.shape[0]), shape[0])
            out[key + "-decode-rows"] = np.concatenate(
                [decode(cfg, params, tok[r]) for r in rows], axis=0)
    # bf16: each rank's combine rounded to bf16 and psum-ed in bf16
    cfg = get_config("deepseek-moe-16b", smoke=True).replace(
        dtype="bfloat16")
    params = JR.init(cfg, jax.random.PRNGKey(0))
    fwd = jax.jit(lambda p, t: JR.forward(p, cfg, {{"tokens": t}})[0])
    out["bf16-unsharded"] = np.asarray(fwd(params, tok), np.float32)
    for shape in {meshes}:
        mesh = jax.make_mesh(shape, ("data", "model"))
        with JM.use_ep_mesh(mesh, token_axes=("data",)):
            lg = jax.jit(lambda p, t: JR.forward(p, cfg, {{"tokens": t}})[0])(
                params, tok)
        out[f"bf16-{{shape[0]}}x{{shape[1]}}"] = np.asarray(lg, np.float32)
    np.savez(sys.argv[2], **out)
    print("EP-OK")
""")


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(11)
    return (rng.integers(0, 512, (B, S)).astype(np.int32),
            rng.integers(0, 512, (2, S)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory, tokens):
    tmp = tmp_path_factory.mktemp("ep")
    np.savez(tmp / "in.npz", tokens=tokens[0])
    env = dict(os.environ, PYTHONPATH="src" + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    script = _SCRIPT.format(cfs=CFS, meshes=MESHES, n=N_DECODE)
    run = subprocess.run(
        [sys.executable, "-c", script, str(tmp / "in.npz"),
         str(tmp / "out.npz")], capture_output=True, text=True, timeout=600,
        env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))))
    assert run.returncode == 0, run.stderr[-3000:]
    assert "EP-OK" in run.stdout
    return dict(np.load(tmp / "out.npz"))


def _jax_params(spiking_t=None, dtype=None):
    from repro.configs import get_config as jget
    from repro.core.spiking import SpikingConfig
    cfg = jget(R.DEEPSEEK, smoke=True)
    if spiking_t is not None:
        cfg = cfg.replace(spiking=SpikingConfig(time_steps=spiking_t))
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    return jax.tree_util.tree_map(np.asarray,
                                  JR.init(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_params():
    return (_jax_params(), _jax_params(SPIKING_T),
            _jax_params(dtype="bfloat16"))


@pytest.fixture(scope="module")
def port_sharded(port_ep):
    return {mesh: port_ep[mesh]["sharded"] for mesh in MESHES}


@pytest.fixture(scope="module")
def port_ep(tmp_path_factory, jax_params, tokens):
    tmp = tmp_path_factory.mktemp("port_ep")
    return {mesh: M.launch(R.moe_ep, *mesh, jax_params[0], tokens[0], CFS,
                           N_DECODE, jax_params[1], tokens[1], SPIKING_T,
                           jax_params[2], device="cpu", store_dir=str(tmp),
                           threads=1)
            for mesh in MESHES}


def _close(got, want, atol=LOGIT_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _key(cf, mesh):
    return f"{cf}-{mesh[0]}x{mesh[1]}"


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ep_forward_matches_jax(jax_ep, port_ep, mesh, cf):
    got = port_ep[mesh][cf]
    _close(got["logits"], jax_ep[_key(cf, mesh) + "-logits"])
    want = float(jax_ep[_key(cf, mesh) + "-aux"])
    assert abs(got["aux"] - want) <= AUX_REL * abs(want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ep_bf16_forward_matches_jax(jax_ep, port_ep, mesh):
    """The bf16 model, where the two ranks' combines are rounded to bf16
    and summed in bf16 (JAX's ``psum(y.astype(x_loc.dtype))``): the
    port's EP logits within BF16_ATOL of JAX's EP logits, while JAX's EP
    and unsharded logits stand more than twice BF16_ATOL apart (that
    rounding, through 3 layers), so a port that summed the fp32 combines
    (the unsharded arithmetic) would fail."""
    want = jax_ep[f"bf16-{mesh[0]}x{mesh[1]}"]
    _close(port_ep[mesh]["bf16"], want, BF16_ATOL)
    assert np.abs(want - jax_ep["bf16-unsharded"]).max() > 2 * BF16_ATOL


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ep_decode_matches_jax(jax_ep, port_ep, mesh, cf):
    """Against JAX's EP decode where it runs; under the installed jax its
    jitted EP decode raises ``ShardingTypeError`` (the cache update meets
    the shard_map output's explicit sharding; ROADMAP queue 3), and the
    reference is then what it computes: JAX's decode of each data rank's
    rows on their own."""
    key = _key(cf, mesh)
    got = port_ep[mesh][cf]["decode"]
    if key + "-decode" in jax_ep:
        _close(got, jax_ep[key + "-decode"])
    else:
        assert str(jax_ep[key + "-decode-error"]) == "ShardingTypeError"
    _close(got, jax_ep[key + "-decode-rows"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ep_forward_matches_the_unsharded_port_where_nothing_drops(
        port_ep, jax_params, tokens, mesh):
    tp = interop.to_torch(jax_params[0], device="cpu")
    want = R.moe_run(R.moe_cfg(8.0), tp, tokens[0], 0)
    _close(port_ep[mesh][8.0]["logits"], want["logits"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_spiking_ep_prefill_matches_the_unsharded_port(port_ep, jax_params,
                                                       tokens, mesh):
    tp = interop.to_torch(jax_params[1], device="cpu")
    want = R.moe_run(R.moe_cfg(8.0, SPIKING_T), tp, tokens[1], 0)
    got = port_ep[mesh]["spiking"]
    _close(got["logits"], want["logits"])
    if mesh[0] == 1:
        # one token shard: the router losses are the unsharded ones (on
        # (2, 2) they are the mean of each timestep's losses, as JAX's
        # pmean of each shard's)
        assert abs(got["aux"] - want["aux"]) <= AUX_REL * abs(want["aux"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ep_keep_holds_only_the_ranks_experts(port_ep, mesh):
    """A rank drawing its params with ``ep_keep`` holds E / ep experts a
    layer, and its EP forward equals the run on the whole stacks (its
    own seed-0 draws, the unsharded port's numbers, not JAX's)."""
    cfg = R.moe_cfg(8.0)
    e_local = cfg.moe.num_experts // mesh[1]
    assert port_ep[mesh]["kept_experts"][1] == e_local
    from repro_torch.models import registry
    whole = registry.init(cfg, 0, device="cpu")
    toks = np.random.default_rng(11).integers(0, 512, (B, S)).astype(np.int32)
    want = R.moe_run(cfg, whole, toks, 0)["logits"]
    _close(port_ep[mesh]["kept"], want)


# ---------------------------------------------------------------------------
# the whole model sharded: _MOE's specs under a MeshScope, and EP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_moe_forward_and_decode_match_jax(jax_ep, port_sharded, mesh,
                                                  cf):
    """Attention on this rank's heads, the dense layer's and the shared
    experts' d_ff columns, the vocab-sharded lookup and head (wo and the
    down products summed over 'model' before their epilogues, each
    layer's weights gathered over 'data'), the routed experts
    expert-parallel: the logits within LOGIT_ATOL of JAX's
    ``use_ep_mesh`` run (whose other layers run whole: the partial sums
    over 'model' round apart from one fp32 sum by a few ulps), the
    decode steps of JAX's decode of each data rank's rows, aux within
    AUX_REL."""
    key = _key(cf, mesh)
    got = port_sharded[mesh][cf]
    _close(got["logits"], jax_ep[key + "-logits"])
    want = float(jax_ep[key + "-aux"])
    assert abs(got["aux"] - want) <= AUX_REL * abs(want)
    _close(got["decode"], jax_ep[key + "-decode-rows"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_moe_bf16_forward_matches_jax(jax_ep, port_sharded, mesh):
    """The bf16 model sharded as above within BF16_ATOL of JAX's EP
    logits (the bf16 sum of the ranks' combines included)."""
    _close(port_sharded[mesh]["bf16"]["logits"],
           jax_ep[f"bf16-{mesh[0]}x{mesh[1]}"], BF16_ATOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_spiking_moe_prefill_matches_the_unsharded_port(
        port_sharded, jax_params, tokens, mesh):
    """The spiking prefill (T = SPIKING_T) with each rank's spiking
    attention on its heads, within LOGIT_ATOL of the port's unsharded
    one."""
    tp = interop.to_torch(jax_params[1], device="cpu")
    want = R.moe_run(R.moe_cfg(8.0, SPIKING_T), tp, tokens[1], 0)
    _close(port_sharded[mesh]["spiking"]["logits"], want["logits"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_moe_rank_holds_its_spec_share(port_sharded, mesh):
    """A rank's parameter bytes are the sum over leaves of its spec's
    local shape: about 1 / (data x model) of the tree (the router and
    the norms replicated)."""
    d, m = mesh
    got = port_sharded[mesh]
    for run in [got[cf] for cf in CFS] + [got["bf16"], got["spiking"]]:
        assert run["bytes"] == run["spec_bytes"]
        assert run["whole_bytes"] < run["bytes"] * d * m \
            < 1.05 * run["whole_bytes"]
