"""The port's mesh server on gloo ranks on the CPU (``launch.mesh.launch``,
a FileStore under ``tmp_path``, one intra-op thread a rank).

JAX's sharded server does not run under the installed jax (ROADMAP queue
3), so the port's is held against the port's unsharded server, which
``test_torch_serve.py`` holds against JAX's; the assertion is JAX's own
test's (``tests/test_serve.py``): every mesh generates the tokens of no
mesh, request by request. The SMOKE servers: spikingformer-lm fp32 and
int8 (its packed spike KV cache; the int8 products' exact accumulators
are summed over 'model' before the epilogue), h2o-danube-3-4b (window
rings, GQA), on 1x2, 2x1 and 2x2, and h2o on 1x4, where its 2 KV heads
do not divide 'model' and every rank keeps them all; gemma3-12b
(local / global groups, tied embeddings) and granite-20b (MQA) on 2x2.

Also: each rank's parameter bytes equal the sum over leaves of numel /
(the product of its spec's mesh sizes); ``shard_put`` then a gather
gives the tree back bitwise, and ``reshard_tree`` gives the same slices;
a checkpoint saved from 2x2 (the gathered tree) and restored onto 1x2
serves the same tokens; ``elastic_restore_plan`` equals JAX's; a (pod,
data, model) mesh over four ranks has the groups its axes say and
serves the unsharded tokens.
"""
import pytest

torch = pytest.importorskip("torch")


from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.parallel.sharding import P  # noqa: E402
from repro_torch.runtime.elastic import elastic_restore_plan  # noqa: E402

import _torch_mesh_ranks as R  # noqa: E402

MESHES = ((1, 2), (2, 1), (2, 2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(data, model): rank 0's results} of one launch a mesh; the 2x2
    launch saves the checkpoint the 1x2 'restored' launch serves."""
    tmp = tmp_path_factory.mktemp("mesh")
    out = {}
    for d, m in MESHES:
        kw = {"ckpt_dir": str(tmp / "ckpt")} if (d, m) == (2, 2) else {}
        out[d, m] = M.launch(R.mesh_servers, d, m, device="cpu",
                             store_dir=str(tmp), threads=1, **kw)
    out["restored"] = M.launch(R.mesh_servers, 1, 2, device="cpu",
                               store_dir=str(tmp), threads=1,
                               restore_dir=str(tmp / "ckpt"))
    return out


@pytest.fixture(scope="module")
def unsharded():
    torch.set_num_threads(1)
    return {name: R.generate(*R.server_setup(arch, q))[0]
            for name, arch, q in R.SERVERS}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", [s[0] for s in R.SERVERS])
def test_mesh_server_generates_the_unsharded_tokens(runs, unsharded, mesh,
                                                    name):
    got = runs[mesh][name]["generated"]
    assert len(got) == R.N_REQ
    assert got == unsharded[name]


def test_gqa_kv_heads_replicated_on_1x4(unsharded, tmp_path):
    """h2o SMOKE's 2 KV heads on model=4: wk / wv replicated (the rules'
    refinement), each rank's query head reading its KV head."""
    got = M.launch(_h2o_only, 1, 4, device="cpu", store_dir=str(tmp_path),
                   threads=1)
    assert got == unsharded["h2o-danube-3-4b"]


@pytest.fixture(scope="module")
def more_on_2x2(tmp_path_factory):
    return M.launch(R.more_servers, 2, 2, device="cpu", threads=1,
                    store_dir=str(tmp_path_factory.mktemp("more")))


@pytest.mark.parametrize("arch", R.MORE_SERVERS)
def test_more_layouts_on_2x2(more_on_2x2, arch):
    """gemma3-12b SMOKE (local / global groups, tied embeddings: the head
    is the vocab-sharded table) and granite-20b SMOKE (MQA: its one KV
    head on every rank) on 2x2 generate the unsharded server's tokens."""
    torch.set_num_threads(1)
    assert more_on_2x2[arch] == R.generate(*R.server_setup(arch, None))[0]


def _h2o_only(mesh):
    return R.generate(*R.server_setup("h2o-danube-3-4b", None), mesh)[0]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", [s[0] for s in R.SERVERS])
def test_rank_param_bytes_match_the_specs(runs, mesh, name):
    r = runs[mesh][name]
    assert r["rank_bytes"] == r["spec_bytes"]
    assert r["param_bytes"]["rank"] == r["rank_bytes"]
    if mesh != (1, 1):
        assert r["rank_bytes"] < r["param_bytes"]["total"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_shard_put_then_gather_is_bitwise(runs, mesh):
    for name, *_ in R.SERVERS:
        assert runs[mesh][name]["roundtrip"], name
        assert runs[mesh][name]["reshard"], name


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_kv_cache_totals_and_rank_share(runs, unsharded, mesh):
    """The KV report's total equals the unsharded cache's bytes; a rank
    holds 1 / (data x model) of the spiking LM's (slots and heads
    split)."""
    d, m = mesh
    cfg, params = R.server_setup("spikingformer-lm", None)
    whole = BatchedServer(cfg, params, R.SLOTS, R.MAX_LEN,
                          device="cpu").kv_cache_stats()
    kv = runs[mesh]["spikingformer-lm fp32"]["kv"]
    assert kv["kv_bytes"] == whole["kv_bytes"]
    assert kv["kv_bytes_rank"] * d * m == whole["kv_bytes"]


def test_elastic_restore_from_2x2_onto_1x2_serves_the_same_tokens(
        runs, unsharded):
    name = R.SERVERS[0][0]
    assert runs["restored"][name]["generated"] == unsharded[name]
    assert runs["restored"][name]["reshard"]


@pytest.mark.parametrize("case", [
    ({"data": 16, "model": 16}, {"data": 8, "model": 16}, 256),
    ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, 256),
    ({"data": 2}, {"data": 4, "model": 2}, 8),
    ({"data": 4}, {"data": 3}, 8),
])
def test_elastic_restore_plan_matches_jax(case):
    from repro.runtime.elastic import elastic_restore_plan as jplan
    old, new, batch = case
    try:
        want = jplan(old, new, batch)
    except ValueError as e:
        with pytest.raises(ValueError, match="not divisible"):
            elastic_restore_plan(old, new, batch)
        assert "not divisible" in str(e)
        return
    assert elastic_restore_plan(old, new, batch) == want


def test_server_refuses_a_non_mesh():
    cfg, params = R.server_setup("spikingformer-lm", None)
    with pytest.raises(TypeError, match="Mesh"):
        BatchedServer(cfg, params, 2, 16, mesh=object(), device="cpu")


def test_mesh_needs_its_ranks_and_production_mesh_names_its_count():
    """Without a process group a 2x2 mesh (and the 256 / 512-rank
    production meshes) is refused with the rank count it needs; a 1x1
    mesh runs in-process."""
    with pytest.raises(ValueError, match="needs 4 ranks"):
        M.make_serve_mesh(2, 2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="needs 256 ranks"):
        M.make_production_mesh(device=torch.device("cpu"))
    with pytest.raises(ValueError, match="needs 512 ranks"):
        M.make_production_mesh(multi_pod=True, device=torch.device("cpu"))
    one = M.make_serve_mesh(1, 1, device=torch.device("cpu"))
    assert one.shape == {"data": 1, "model": 1}
    assert M.parse_mesh("2x4") == (2, 4)
    with pytest.raises(ValueError):
        M.parse_mesh("2-4")
    assert P("data", None) == ("data", None)


def test_pod_mesh_groups_and_server(unsharded, tmp_path):
    """A (pod 2, data 1, model 2) mesh built over a 2x2 launch's ranks
    (``make_production_mesh(multi_pod=True)``'s axes, at 4 ranks): the
    ranks lie row-major over it, each set of axes' group holds the ranks
    that differ only along them (an all-reduce of the rank ids), and the
    fp32 SMOKE server (slots over ('pod', 'data')) generates the
    unsharded server's tokens."""
    got = M.launch(R.pod_mesh, 2, 2, device="cpu", store_dir=str(tmp_path),
                   threads=1)
    for rank, coords, sums in got["ranks"]:
        p, m = divmod(rank, 2)
        assert coords == {"pod": p, "data": 0, "model": m}
        want = {("pod",): 2 + 2 * m, ("data",): rank, ("model",): 4 * p + 1,
                ("pod", "data"): 2 + 2 * m, ("pod", "model"): 6,
                ("data", "model"): 4 * p + 1, ("pod", "data", "model"): 6}
        assert sums == want, rank
    assert got["generated"] == unsharded["spikingformer-lm fp32"]
