"""The port's sharding tables against the JAX package's, with no
processes: ``parallel.rules.params_partition`` (schemes 'fsdp' and
'zero1'), ``batch_partition`` and ``cache_partition`` leaf by leaf, for
every arch in ``ALL_ARCHS`` at its full config, on duck-typed meshes
(as ``tests/test_sharding_rules.py`` uses) of 1x1, 2x2, 4x2, 16x16 and
2x16x16, at ``TRAIN_4K``, ``DECODE_32K`` and ``LONG_500K``. Abstract
shapes only: JAX's ``eval_shape`` trees, the port's on the meta device
(``launch.steps.abstract_params`` / ``cache_struct`` allocate nothing).
Then the cases of ``tests/test_sharding_rules.py``, restated against the
port. Specs are compared entry by entry (``tuple``), exactly."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.shapes import (DECODE_32K as JDECODE,  # noqa: E402
                                  LONG_500K as JLONG, TRAIN_4K as JTRAIN)
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.parallel import rules as jrules  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.configs.shapes import (DECODE_32K, LONG_500K,  # noqa: E402
                                        TRAIN_4K)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.parallel import rules  # noqa: E402
from repro_torch.parallel.sharding import (P, fit_spec_to_shape,  # noqa
                                           logical_spec, param_specs,
                                           rules_for_mesh, tree_map_with_path,
                                           use_rules)


def _mesh(*sizes):
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                        "model")

    class Duck:
        axis_names = names
        shape = dict(zip(names, sizes))
        devices = np.empty(sizes)
    Duck.__name__ = "x".join(map(str, sizes))
    return Duck()


MESHES = [(1, 1), (2, 2), (4, 2), (16, 16), (2, 16, 16)]
SHAPES = [(TRAIN_4K, JTRAIN), (DECODE_32K, JDECODE), (LONG_500K, JLONG)]

_ABSTRACT = {}


def _abstract(arch):
    """(jcfg, cfg, JAX's eval_shape params, the port's meta params),
    cached."""
    if arch not in _ABSTRACT:
        jcfg, cfg = jget_config(arch), get_config(arch)
        _ABSTRACT[arch] = (jcfg, cfg, jsteps.abstract_params(jcfg),
                           steps.abstract_params(cfg))
    return _ABSTRACT[arch]


def _jax_flat(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    out = {}
    for path, spec in flat:
        parts = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        out["/".join(parts)] = tuple(spec)
    return out


def _port_flat(specs):
    out = {}
    tree_map_with_path(lambda path, s: out.__setitem__(path, tuple(s)),
                       specs)
    return out


def _jax_shapes(tree):
    return {k: tuple(v) for k, v in _jax_flat(jax.tree_util.tree_map(
        lambda a: JP(*a.shape), tree)).items()}


def _port_shapes(tree):
    out = {}
    tree_map_with_path(lambda path, a: out.__setitem__(path,
                                                       tuple(a.shape)), tree)
    return out


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_batch_and_cache_specs_equal_jax(arch, sizes):
    jcfg, cfg, jp, tp = _abstract(arch)
    mesh = _mesh(*sizes)
    assert _port_shapes(tp) == _jax_shapes(jp)
    assert all(a.device.type == "meta" for a in
               __import__("repro_torch.tree", fromlist=["x"]).tree_leaves(tp))
    for scheme in ("fsdp", "zero1"):
        want = _jax_flat(jrules.params_partition(jcfg, jp, mesh, scheme))
        got = _port_flat(rules.params_partition(cfg, tp, mesh, scheme))
        assert got == want, scheme
    for shape, jshape in SHAPES:
        want = _jax_flat(jrules.batch_partition(
            jcfg, jshape, mesh, jsteps.batch_struct(jcfg, jshape)))
        got = _port_flat(rules.batch_partition(
            cfg, shape, mesh, steps.batch_struct(cfg, shape)))
        assert got == want, shape.name
        assert rules.batch_axes(shape, mesh) == jrules.batch_axes(jshape,
                                                                  mesh)
        if not JR.has_decode(jcfg):
            continue
        jcache = jsteps.cache_struct(jcfg, jshape)
        cache = steps.cache_struct(cfg, shape)
        assert _port_shapes(cache) == _jax_shapes(jcache)
        want = _jax_flat(jrules.cache_partition(jcfg, jshape, mesh, jcache))
        got = _port_flat(rules.cache_partition(cfg, shape, mesh, cache))
        assert got == want, shape.name


@pytest.mark.parametrize("arch", ["spikingformer-lm", "deepseek-moe-16b"])
def test_decode_inputs_struct_mirrors_jax(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jc, jt, jpos = jsteps.decode_inputs_struct(jcfg, JDECODE)
    c, t, pos = steps.decode_inputs_struct(cfg, DECODE_32K)
    assert _port_shapes(c) == _jax_shapes(jc)
    assert tuple(t.shape) == jt.shape and tuple(pos.shape) == jpos.shape
    assert t.device.type == "meta" and t.dtype == torch.int32


# ---------------------------------------------------------------------------
# tests/test_sharding_rules.py, restated against the port
# ---------------------------------------------------------------------------


def test_fit_spec_right_aligns_for_stacked_params():
    s = fit_spec_to_shape(P("data", "model"), (32, 64, 128), _mesh(1, 1))
    assert tuple(s) == (None, "data", "model")


def test_fit_spec_drops_nondividing():
    class FakeMesh:
        axis_names = ("model",)
        devices = np.empty((16,))
    s = fit_spec_to_shape(P("model"), (25,), FakeMesh())
    assert tuple(s) == ()


def test_logical_spec_keeps_positional_nones():
    s = logical_spec(("batch", "seq", "embed"),
                     dict(batch="data", seq=None, embed=None))
    assert tuple(s)[0] == "data" and len(s) == 3


def test_dense_rules_cover_all_leaves():
    cfg = get_config("nemotron-4-15b", smoke=True)
    specs = rules.params_partition(cfg, steps.abstract_params(cfg),
                                   _mesh(1, 1))
    named = [p for p in _port_flat(specs) if "wq" in p]
    assert named, "attention projections must be matched by rules"


def test_zero1_strips_fsdp_axis():
    cfg = get_config("nemotron-4-15b", smoke=True)
    d_f = dict(rules.rules_for(cfg, _mesh(1, 1), "fsdp"))
    d_z = dict(rules.rules_for(cfg, _mesh(1, 1), "zero1"))
    assert d_f[r"mlp/(up|gate)/(w|b)"] == P("data", "model")
    assert d_z[r"mlp/(up|gate)/(w|b)"] == P(None, "model")


def test_kv_replication_rule_when_heads_dont_divide():
    m16 = _mesh(16, 16)
    r = rules.rules_for(get_config("kimi-k2-1t-a32b"), m16)
    assert r[0] == (r"(wk|wv)/(w|b)", P("data", None))
    r2 = rules.rules_for(get_config("nemotron-4-15b"), m16)
    assert r2[0][1] == P("data", None)


def test_cache_partition_long_context_shards_seq():
    cfg = get_config("h2o-danube-3-4b")
    cache = steps.cache_struct(cfg, LONG_500K)
    specs = rules.cache_partition(cfg, LONG_500K, _mesh(16, 16), cache)
    assert "data" in tuple(specs["layers"]["k"])


def test_constrain_fits_batch_one():
    from repro_torch.parallel.sharding import constrain
    with use_rules(rules_for_mesh(_mesh(1, 1))):
        x = torch.zeros((1, 8, 16))
        assert constrain(x, "batch", "seq", "embed") is x


def test_batch_axes_decode_shapes():
    m = _mesh(16, 16)
    assert rules.batch_axes(TRAIN_4K, m) == ("data",)
    assert rules.batch_axes(DECODE_32K, m) == ("data",)
    assert rules.batch_axes(LONG_500K, m) == ()


def test_param_specs_first_match_wins_and_spec_equals_jax_p():
    tree = {"a": {"w": torch.empty((4, 8), device="meta")},
            "b": torch.empty((8,), device="meta")}
    specs = param_specs(tree, [(r"a/w", P("data", None)), (r"a", P("model")),
                               (r"b", P("model"))], mesh=_mesh(2, 2))
    assert specs["a"]["w"] == JP("data")
    assert specs["b"] == P("model") and specs["b"] == JP("model")
