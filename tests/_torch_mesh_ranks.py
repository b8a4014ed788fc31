"""Functions the mesh tests run on every rank (``launch.mesh.launch``
pickles them by reference, so they live in an importable module that
imports no JAX)."""
import dataclasses

import numpy as np
import torch

from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import moe as TM
from repro_torch.models import registry
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import local_shape, shard_put
from repro_torch.quant import quantize_tree
from repro_torch.runtime.elastic import reshard_tree
from repro_torch.tree import tree_leaves, tree_map

# (name, arch, quantize): the SMOKE servers the mesh tests hold
SERVERS = (("spikingformer-lm fp32", "spikingformer-lm", None),
           ("spikingformer-lm int8", "spikingformer-lm", "int8"),
           ("h2o-danube-3-4b", "h2o-danube-3-4b", None))
SLOTS, MAX_LEN, N_REQ, PROMPT, NEW = 4, 24, 5, 7, 4


def server_setup(arch, quantize):
    """(cfg, params) of a SMOKE server on the CPU, seed 0."""
    cfg = get_config(arch, smoke=True)
    params = registry.init(cfg, 0, device="cpu")
    if quantize is not None:
        params = quantize_tree(params, quantize)
        cfg = cfg.replace(engine=cfg.engine.replace(weights=quantize))
    return cfg, params


def requests(cfg):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=p, max_new_tokens=NEW) for i, p in
            enumerate(rng.integers(0, cfg.vocab_size, (N_REQ, PROMPT))
                      .astype(np.int32))]


def generate(cfg, params, mesh=None):
    """{rid: generated tokens} of the server, and the server."""
    server = BatchedServer(cfg, params, SLOTS, MAX_LEN, mesh=mesh,
                           device="cpu")
    for r in requests(cfg):
        server.submit(r)
    server.run()
    return {r.rid: r.generated for r in server.completed}, server


def mesh_servers(mesh, ckpt_dir=None, restore_dir=None):
    """Every SMOKE server on ``mesh``: its generations, this rank's
    parameter bytes beside the specs' share, whether shard_put then a
    gather gives the tree back bitwise; with ``ckpt_dir`` the first
    server's params gathered and saved (rank 0) as a checkpoint; with
    ``restore_dir`` that checkpoint restored and resharded onto ``mesh``
    and served."""
    out = {}
    for name, arch, quantize in SERVERS:
        if restore_dir is not None and name != SERVERS[0][0]:
            continue
        cfg, params = server_setup(arch, quantize)
        if restore_dir is not None:
            params, _, _ = CheckpointManager(restore_dir).restore(
                device="cpu")
        gen, server = generate(cfg, params, mesh)
        mine = sum(a.numel() * a.element_size()
                   for a in tree_leaves(server.params))
        share = sum(int(np.prod(local_shape(a.shape, s, mesh)))
                    * a.element_size() for a, s in zip(
                        tree_leaves(params), tree_leaves(server.param_specs)))
        full = collectives.gather_tree(server.params, server.param_specs,
                                       mesh)
        back = all(torch.equal(a, b) for a, b in zip(tree_leaves(full),
                                                     tree_leaves(params)))
        again = shard_put(params, server.param_specs, mesh)
        resharded = reshard_tree(params, server.param_specs, mesh)
        same = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(
            tree_leaves(server.params), tree_leaves(again),
            tree_leaves(resharded)))
        out[name] = dict(generated=gen, rank_bytes=mine, spec_bytes=share,
                         roundtrip=back, reshard=same,
                         kv=server.kv_cache_stats(),
                         param_bytes=server.param_bytes())
        if ckpt_dir is not None and name == SERVERS[0][0]:
            if mesh.rank == 0:
                CheckpointManager(ckpt_dir).save(0, full, blocking=True)
            torch.distributed.barrier()
    return out


# the other served layouts: local_global groups with tied embeddings
# (gemma3-12b) and MQA, whose one KV head every rank keeps (granite-20b)
MORE_SERVERS = ("gemma3-12b", "granite-20b")


def more_servers(mesh):
    """{arch: generated tokens} of MORE_SERVERS' SMOKE servers on
    ``mesh``."""
    return {arch: generate(*server_setup(arch, None), mesh)[0]
            for arch in MORE_SERVERS}


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

DEEPSEEK = "deepseek-moe-16b"


def moe_cfg(cf, spiking_t=None):
    from repro_torch.core.spiking import SpikingConfig
    cfg = get_config(DEEPSEEK, smoke=True)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    if spiking_t is not None:
        cfg = cfg.replace(spiking=SpikingConfig(time_steps=spiking_t))
    return cfg


def moe_run(cfg, tp, tokens, n_decode):
    """(logits, moe_aux) of the forward on ``tokens`` and the logits of
    ``n_decode`` token-by-token decode steps (dense configs)."""
    with torch.inference_mode():
        logits, aux = registry.forward(tp, cfg, {"tokens": torch.from_numpy(
            tokens)})
    out = {"logits": logits.numpy(), "aux": float(aux["moe_aux"])}
    if n_decode:
        b = tokens.shape[0]
        cache = registry.init_cache(cfg, b, n_decode, device="cpu")
        step = steps.build_serve_step(cfg, device="cpu")
        dec = []
        for i in range(n_decode):
            lg, cache = step(tp, cache, torch.from_numpy(tokens[:, i:i + 1]),
                             i)
            dec.append(lg.numpy())
        out["decode"] = np.concatenate(dec, axis=1)
    return out


def moe_ep(mesh, jp, tokens, cfs, n_decode, jp_spiking, spiking_tokens,
           spiking_t, jp_bf16):
    """Every capacity factor's forward and decode under ``use_ep_mesh``
    (token axes ('data',)), on JAX's params; then the spiking prefill and
    the bf16 model's forward at capacity 8.0. Also each rank's expert
    bytes (its slices only, drawn through ``ep_keep`` and run under a
    ``MeshScope``), and :func:`moe_sharded`'s runs."""
    from repro_torch.parallel import spmd
    tp = interop.to_torch(jp, device="cpu")
    out = {}
    with TM.use_ep_mesh(mesh, token_axes=("data",)):
        for cf in cfs:
            out[cf] = moe_run(moe_cfg(cf), tp, tokens, n_decode)
        out["spiking"] = moe_run(moe_cfg(8.0, spiking_t), interop.to_torch(
            jp_spiking, device="cpu"), spiking_tokens, 0)
        out["bf16"] = moe_run(moe_cfg(8.0).replace(dtype="bfloat16"),
                              interop.to_torch(jp_bf16, device="cpu"),
                              tokens, 0)["logits"].astype(np.float32)
        cfg = moe_cfg(8.0)
        kept = TM.init(cfg, 0, device="cpu", keep=TM.ep_keep(cfg, mesh))
        with spmd.use_mesh(spmd.MeshScope(mesh, cfg,
                                          TM.mesh_specs(cfg, mesh))):
            out["kept"] = moe_run(cfg, kept, tokens, 0)["logits"]
        out["kept_experts"] = tuple(kept["layers"]["moe"]["up"].shape)
    out["sharded"] = moe_sharded(mesh, jp, tokens, cfs, n_decode, jp_bf16,
                                 jp_spiking, spiking_tokens, spiking_t)
    return out


# ---------------------------------------------------------------------------
# a mesh with a 'pod' axis
# ---------------------------------------------------------------------------

POD_AXES = (("pod",), ("data",), ("model",), ("pod", "data"),
            ("pod", "model"), ("data", "model"), ("pod", "data", "model"))


def pod_mesh(mesh):
    """On the ranks of ``mesh``, a (pod 2, data 1, model 2) mesh: every
    rank's coordinates and, for each set of axes, the sum of the rank ids
    over that set's group (every rank's, gathered); then the fp32 SMOKE
    spikingformer-lm server's generations on it."""
    from repro_torch.launch.mesh import Mesh
    pod = Mesh({"pod": 2, "data": 1, "model": 2}, mesh.device)
    sums = {axes: int(collectives.all_reduce(torch.tensor([pod.rank]), pod,
                                             axes))
            for axes in POD_AXES}
    every = [None] * pod.devices.size
    torch.distributed.all_gather_object(every, (pod.rank, pod.coords, sums))
    gen = generate(*server_setup("spikingformer-lm", None), pod)[0]
    return dict(ranks=every, generated=gen)


def moe_sharded(mesh, jp, tokens, cfs, n_decode, jp_bf16, jp_spiking,
                spiking_tokens, spiking_t):
    """The MoE sharded as ``_MOE``'s specs say (``moe.mesh_specs``:
    attention heads, the dense and shared experts' d_ff and the vocab
    over 'model', FSDP over 'data', the routed experts over 'model'), on
    JAX's params put through ``shard_put``, under a ``MeshScope`` and
    ``use_ep_mesh`` (token axes ('data',)): every capacity factor's
    forward and decode, the bf16 forward and the spiking prefill at
    capacity 8.0, and this rank's parameter bytes against the whole
    tree's."""
    from repro_torch.parallel import spmd

    def run(cfg, params, n, tokens=tokens):
        specs = TM.mesh_specs(cfg, mesh)
        whole = interop.to_torch(params, device="cpu")
        local = shard_put(whole, specs, mesh)
        with TM.use_ep_mesh(mesh, token_axes=("data",)), \
                spmd.use_mesh(spmd.MeshScope(mesh, cfg, specs)):
            got = moe_run(cfg, local, tokens, n)
        got["bytes"] = sum(a.numel() * a.element_size()
                           for a in tree_leaves(local))
        got["spec_bytes"] = sum(tree_leaves(tree_map(
            lambda a, s: int(np.prod(local_shape(a.shape, s, mesh)))
            * a.element_size(), whole, specs)))
        got["whole_bytes"] = sum(a.numel() * a.element_size()
                                 for a in tree_leaves(whole))
        return got
    out = {cf: run(moe_cfg(cf), jp, n_decode) for cf in cfs}
    out["bf16"] = run(moe_cfg(8.0).replace(dtype="bfloat16"), jp_bf16, 0)
    out["bf16"]["logits"] = out["bf16"]["logits"].astype(np.float32)
    out["spiking"] = run(moe_cfg(8.0, spiking_t), jp_spiking, 0,
                         spiking_tokens)
    return out
