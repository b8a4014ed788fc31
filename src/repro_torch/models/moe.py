"""Mixture-of-Experts decoder LM (deepseek-moe-16b, kimi-k2-1t-a32b).

Mirrors ``repro.models.moe``, its expert parallelism included: under
:class:`use_ep_mesh` (a ``launch.mesh.Mesh`` of ranks) ``moe_ffn`` runs
JAX's ``shard_map`` branch on each rank: the tokens split over the token
axes (dim 0) and replicated over the expert axis, ``E / ep`` experts a
rank from ``local_offset = rank_in_axis * e_local`` (a rank holds only
them, or the whole stack, of which it reads its slice), capacity from
the rank's tokens, each rank's combine cast to the activation dtype and
summed over the expert axis in that dtype (JAX's bf16 ``psum``), the
router losses averaged over the token axes, the output gathered back
over them. With whole params everything else runs replicated on every
rank, as JAX's ``use_ep_mesh`` leaves unsharded params; with a rank's
slices under :func:`mesh_specs` (``_MOE``'s table; :func:`ep_keep` draws
only them) and a ``parallel.spmd.MeshScope``, the rest runs as GSPMD
runs those specs: attention on this rank's heads, the dense layers' and
shared experts' d_ff columns, wo and the down products summed over
'model' before their epilogues, the vocab-sharded lookup and head.
Without a mesh every expert is local. The routed FFN is sort-based
capacity dispatch:
a stable argsort of the (token, choice) pairs by expert id, a
capacity-bounded gather of each expert's tokens, the batched expert
products, and a combine that adds each token's weighted expert outputs
back in fp32.

* The expert products are ``torch.bmm`` in the activation dtype, as
  JAX's einsums with ``preferred_element_type=xg.dtype`` (bf16 operands,
  fp32 sums, bf16 out): no fp32 copy of an expert stack is made (a kimi
  layer's experts are 34 GB in bf16). The router is fp32 in any model
  dtype, as in JAX.
* The combine adds no float atomically: each token sums its weighted
  expert outputs in fp32, in ascending slot order (ascending expert id),
  starting from zero. That is the order of JAX's scatter-add over the
  slots (``out.at[tok_of_slot].add``) when it runs the updates one by
  one, as XLA's CPU scatter does; slots a token does not hold (its
  overflowed choices, the zero-weight padding of short experts) add
  zeros, which change no sum. Two runs on the card agree bitwise.
* Routing ties: ``router_topk`` takes the top-k by a stable descending
  sort, so the lower expert id wins a tie, as ``lax.top_k`` does.
* In spiking mode (``cfg.spiking``) attention spikes q / k / v with LIF
  over the time axis and runs the binary engine's attention with T
  folded into the batch (``spiking_attention``: kernel #7, or #8 with
  ``binary='popcount'``, on the card); the FFNs see every timestep's
  tokens, and the logits read the mean over T. Decode is dense only:
  the reference's spiking MoE decode fails (ROADMAP queue 3), and the
  port refuses it.
* Decode takes one token a row at a scalar position against a cache of
  ``max_len`` entries a layer (``build_serve_step``); the family has no
  per-slot state, so ``BatchedServer`` refuses it, as in JAX. The cache
  is updated in place and returned. Routing capacity follows the tokens
  of the call (B in a decode step), as in JAX, so a decode step can drop
  choices that the whole-prompt forward keeps (ROADMAP queue 3).
"""
from __future__ import annotations

import math
import threading
from itertools import product
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel import collectives, spmd
from repro_torch.parallel.rules import dp_part, params_partition
from repro_torch.parallel.sharding import P, local_slice, tree_map_with_path
from repro_torch.tree import tree_map
from . import nn
from .transformer import (_attend_full_seq, _head_sharded, _mlp,
                          _project_qkv, _row, _spike, _stacked_layers,
                          dtype_of)


# ---------------------------------------------------------------------------
# Mesh context for EP (installed by the launch layer)
# ---------------------------------------------------------------------------

_ctx = threading.local()


def set_ep_mesh(mesh, token_axes=("pod", "data"), expert_axis="model"):
    _ctx.mesh = mesh
    _ctx.token_axes = token_axes
    _ctx.expert_axis = expert_axis


def clear_ep_mesh():
    _ctx.mesh = None


def get_ep_mesh():
    return getattr(_ctx, "mesh", None), \
        getattr(_ctx, "token_axes", ("pod", "data")), \
        getattr(_ctx, "expert_axis", "model")


class use_ep_mesh:
    def __init__(self, mesh, token_axes=("pod", "data"), expert_axis="model"):
        self.args = (mesh, token_axes, expert_axis)

    def __enter__(self):
        self.prev = get_ep_mesh()
        set_ep_mesh(*self.args)

    def __exit__(self, *exc):
        set_ep_mesh(*self.prev)


def mesh_specs(cfg: ModelConfig, mesh):
    """The param spec tree of ``cfg`` on ``mesh``: ``parallel/rules.py``'s
    ``_MOE`` table (the routed experts over 'model', attention heads, the
    dense and shared experts' d_ff and the vocab over 'model', FSDP over
    'data'), on the meta-device tree."""
    return params_partition(cfg, init(cfg, 0, device="meta"), mesh)


def ep_keep(cfg: ModelConfig, mesh):
    """An ``init(keep=...)`` that keeps this rank's slice of every leaf
    under :func:`mesh_specs`: the routed expert stacks as each is drawn,
    so a rank never holds the other ranks' experts, the rest once drawn.
    Run the model on the result under a ``spmd.MeshScope`` with those
    specs and :class:`use_ep_mesh`."""
    flat = {}
    tree_map_with_path(lambda path, spec: flat.__setitem__(path, spec),
                       mesh_specs(cfg, mesh))

    def keep(path, leaf):
        return local_slice(leaf, flat[path], mesh).clone()
    return keep


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _expert_shapes(cfg: ModelConfig):
    """{name: (per-expert shape, init std)} of the routed expert stacks."""
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    return {"up": ((d, f), 1.0 / math.sqrt(d)),
            "gate": ((d, f), 1.0 / math.sqrt(d)),
            "down": ((f, d), 1.0 / math.sqrt(f))}


def _attn_init(gen: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    p = {
        "ln1": nn.rmsnorm_init(cfg.d_model, dt),
        "wq": nn.linear_init(gen, cfg.d_model, cfg.q_dim, dtype=dt),
        "wk": nn.linear_init(gen, cfg.d_model, cfg.kv_dim, dtype=dt),
        "wv": nn.linear_init(gen, cfg.d_model, cfg.kv_dim, dtype=dt),
        "wo": nn.linear_init(
            gen, cfg.q_dim, cfg.d_model,
            std=1.0 / math.sqrt(cfg.q_dim * 2 * cfg.num_layers), dtype=dt),
        "ln2": nn.rmsnorm_init(cfg.d_model, dt),
    }
    if cfg.spiking is not None:
        p["delta"] = torch.tensor(cfg.spiking.attn_threshold_init,
                                  dtype=torch.float32)
    return p


def _moe_layer_init(gen: torch.Generator, cfg: ModelConfig):
    """A MoE layer without its expert stacks (:func:`_expert_stacks` draws
    them); the router fp32 in any model dtype."""
    m, dt = cfg.moe, dtype_of(cfg)
    p = _attn_init(gen, cfg)
    p["moe"] = {"router": nn.normal(gen, (cfg.d_model, m.num_experts),
                                    1.0 / math.sqrt(cfg.d_model),
                                    torch.float32)}
    if m.num_shared:
        p["moe"]["shared"] = nn.mlp_init(gen, cfg.d_model,
                                         m.num_shared * m.d_ff_expert,
                                         gated=True, dtype=dt)
    return p


def _dense_layer_init(gen: torch.Generator, cfg: ModelConfig):
    p = _attn_init(gen, cfg)
    p["mlp"] = nn.mlp_init(gen, cfg.d_model,
                           cfg.moe.first_dense_ff or cfg.d_ff, gated=True,
                           dtype=dtype_of(cfg))
    return p


def _expert_stacks(gen: torch.Generator, cfg: ModelConfig, n: int,
                   dev: torch.device, keep):
    """{up, gate, down}: (n, E, ...) expert stacks, drawn expert by expert
    into their slices (a kimi layer's experts, 34 GB in bf16, never exist
    twice), each passed through ``keep`` as soon as it is drawn."""
    dt = dtype_of(cfg)
    stacks = {}
    for name, (shape, std) in _expert_shapes(cfg).items():
        full = torch.empty((n, cfg.moe.num_experts, *shape), dtype=dt,
                           device=dev)
        for i, e in product(range(n), range(cfg.moe.num_experts)):
            full[i, e].copy_(nn.normal(gen, shape, std, dt))
        stacks[name] = keep(f"layers/moe/{name}", full)
        del full
    return stacks


def init(cfg: ModelConfig, seed: int = 0, *,
         device: DeviceLike = None, keep=None) -> Dict[str, Any]:
    """Params in the JAX layout (``dense_layers`` and ``layers`` stacked
    on a leading axis; ``moe.{router, up, gate, down, shared}``) from a
    ``torch.Generator`` on ``device`` (the GPU by default) seeded with
    ``seed`` (not JAX's numbers: tests convert JAX's params instead). Each
    leaf is drawn where it lives. ``keep(path, leaf)`` (e.g.
    :func:`ep_keep`) maps each routed expert stack as soon as it is drawn,
    before the next is, and the other leaves once the tree is drawn: the
    draws are the same whatever it keeps."""
    dev = resolve_device(device)
    keep = keep if keep is not None else (lambda path, leaf: leaf)
    gen = nn.generator(dev).manual_seed(seed)
    dt = dtype_of(cfg)
    m = cfg.moe
    params: Dict[str, Any] = {
        "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": nn.rmsnorm_init(cfg.d_model, dt),
        "lm_head": nn.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                  dtype=dt),
    }
    if m.first_k_dense:
        params["dense_layers"] = _stacked_layers(
            gen, cfg, (m.first_k_dense,), dev, _dense_layer_init)
    n_moe = cfg.num_layers - m.first_k_dense
    layers = _stacked_layers(gen, cfg, (n_moe,), dev, _moe_layer_init)
    ffn = layers["moe"]
    layers["moe"] = {"router": ffn["router"],
                     **_expert_stacks(gen, cfg, n_moe, dev, keep),
                     **({"shared": ffn["shared"]} if "shared" in ffn
                        else {})}
    params["layers"] = layers
    kept = {f"layers/moe/{name}" for name in _expert_shapes(cfg)}
    return tree_map_with_path(
        lambda path, a: a if path in kept else keep(path, a.to(dev)),
        params)


# ---------------------------------------------------------------------------
# routing + dispatch
# ---------------------------------------------------------------------------


def router_topk(x2d: torch.Tensor, router_w: torch.Tensor, m: MoEConfig):
    """x2d: (T, D) -> (weights (T, K) fp32, idx (T, K), aux_lb, aux_z)."""
    logits = x2d.float() @ router_w                           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: the lower expert id first on a tie
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = vals[:, :m.top_k], ids[:, :m.top_k]
    if m.normalize_topk:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load balance loss + router z-loss
    me = probs.mean(dim=0)                                    # (E,)
    assign = torch.zeros_like(probs).scatter_(1, idx, 1.0).mean(dim=0)
    aux_lb = m.num_experts * torch.sum(me * assign)
    aux_z = torch.logsumexp(logits, dim=-1).square().mean()
    return w.float(), idx, aux_lb, aux_z


def _local_expert_ffn(xg: torch.Tensor, up, gate, down,
                      act: str) -> torch.Tensor:
    """xg: (E_loc, C, D) -> (E_loc, C, D); batched expert products in
    xg's dtype (fp32 sums)."""
    h = torch.bmm(xg, up)
    g = torch.bmm(xg, gate)
    h = nn.activation(act)(g) * h
    return torch.bmm(h, down)


def _dispatch_local(x2d: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                    up, gate, down, m: MoEConfig, act: str, e_local: int,
                    local_offset, out_dtype=None) -> torch.Tensor:
    """Sort-based capacity dispatch for the local expert slice.

    x2d (T, D); w / idx (T, K); expert weights (E_loc, ...). Choices of
    non-local experts are ignored here (another shard owns them). The
    fp32 combine is returned in ``out_dtype`` (default x2d's)."""
    t, d = x2d.shape
    k = m.top_k
    dev = x2d.device
    cap = max(1, int(math.ceil(t * k / m.num_experts * m.capacity_factor)))

    flat_e = idx.reshape(-1)                        # (T*K,) global expert ids
    local_e = flat_e - local_offset
    is_local = (local_e >= 0) & (local_e < e_local)
    sort_key = torch.where(is_local, local_e, torch.full_like(local_e,
                                                              e_local))
    order = torch.argsort(sort_key, stable=True)
    sorted_e = sort_key[order]
    sorted_tok = torch.div(torch.arange(t * k, device=dev), k,
                           rounding_mode="floor")[order]
    sorted_w = w.reshape(-1)[order]

    # each expert's run in the sorted order (no atomic histogram)
    bounds = torch.searchsorted(sorted_e, torch.arange(e_local + 1,
                                                       device=dev))
    offsets, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    ar = torch.arange(cap, device=dev)
    slot = offsets[:, None] + ar[None, :]                     # (E_loc, C)
    valid = ar[None, :] < torch.clamp(counts, max=cap)[:, None]
    slot = slot.clamp(0, t * k - 1)
    tok_of_slot = sorted_tok[slot]                            # (E_loc, C)

    xg = x2d[tok_of_slot.reshape(-1)].reshape(e_local, cap, d)
    yg = _local_expert_ffn(xg, up, gate, down, act)

    # the combine: each (token, choice) pair's slot, if it holds one
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=dev)            # sorted position
    e_of = sort_key.clamp(max=e_local - 1)
    r = rank - offsets[e_of]
    held = is_local & (r < cap)
    sentinel = e_local * cap
    slot_of = torch.where(held, sort_key * cap + r,
                          torch.full_like(r, sentinel)).reshape(t, k)
    # a token's slots in ascending order, as the slots are laid out
    slot_of, pick = torch.sort(slot_of, dim=-1)
    w_of = w.gather(1, pick)
    y_flat = yg.reshape(e_local * cap, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for j in range(k):
        s = slot_of[:, j]
        ok = s < sentinel
        y = y_flat[s.clamp(max=sentinel - 1)].float() * w_of[:, j, None]
        out = out + torch.where(ok[:, None], y, 0.0)
    return out.to(x2d.dtype if out_dtype is None else out_dtype)


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (..., S, D) -> (y, aux_loss): the routed experts plus the shared
    experts; expert-parallel over the ranks of an installed EP mesh."""
    m = cfg.moe
    mesh, token_axes, expert_axis = get_ep_mesh()
    if mesh is None and spmd.current() is not None:
        raise ValueError("a MoE on a mesh scope runs its routed experts "
                         "expert-parallel: install use_ep_mesh too")

    def run(x_loc, up, gate, down, e_local, offset):
        x2d = x_loc.reshape(-1, x_loc.shape[-1])
        w, idx, aux_lb, aux_z = router_topk(x2d, p["router"], m)
        y = _dispatch_local(x2d, w, idx, up, gate, down, m, cfg.act,
                            e_local, offset)
        aux = m.router_aux_weight * aux_lb + m.router_z_weight * aux_z
        return y.reshape(x_loc.shape), aux

    if mesh is None:
        y, aux = run(x, p["up"], p["gate"], p["down"], m.num_experts, 0)
    else:
        e_local = m.num_experts // mesh.shape[expert_axis]
        offset = mesh.coords[expert_axis] * e_local
        experts = [p[k] if p[k].shape[0] == e_local
                   else p[k][offset:offset + e_local]
                   for k in ("up", "gate", "down")]
        axes = tuple(a for a in token_axes if a in mesh.axis_names)
        x_loc = local_slice(x, P(dp_part(axes)), mesh)
        y, aux = run(x_loc, *experts, e_local, offset)
        # each rank's combine, already in the activation dtype, summed over
        # the expert axis in that dtype (JAX's bf16 psum)
        y = collectives.all_reduce(y.to(x.dtype), mesh, expert_axis)
        if axes:
            aux = collectives.pmean(aux, mesh, axes)
            y = collectives.all_gather(y, mesh, axes, 0)
    if m.num_shared:
        y = y + _mlp(p["shared"], x, cfg.act, "shared")
    return y, aux


# ---------------------------------------------------------------------------
# layers / forward / decode
# ---------------------------------------------------------------------------


def _attn_block(p, cfg: ModelConfig, x: torch.Tensor, positions,
                train: bool) -> torch.Tensor:
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, h, positions, repeat_kv=True)
    if cfg.spiking is not None:
        q, k, v = (_spike(u, cfg) for u in (q, k, v))
        fold = lambda u: u.reshape(-1, *u.shape[2:])
        attn = _attend_full_seq(cfg, "full", fold(q), fold(k), fold(v),
                                delta=p["delta"])
    else:
        attn = _attend_full_seq(cfg, "full", q, k, v)
    attn = attn.reshape(*x.shape[:-1], cfg.q_dim)
    return x + _row(p["wo"], attn, "attn")


def _moe_layer(p, cfg: ModelConfig, x: torch.Tensor, positions,
               train: bool):
    x = _attn_block(p, cfg, x, positions, train)
    h = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
    y, aux = moe_ffn(p["moe"], h, cfg)
    return x + y, aux


def _dense_layer(p, cfg: ModelConfig, x: torch.Tensor, positions,
                 train: bool) -> torch.Tensor:
    x = _attn_block(p, cfg, x, positions, train)
    h = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + _mlp(p["mlp"], h, cfg.act)


def _stack_layer(stack, i: int):
    return tree_map(lambda a: a[i], stack)


def _layer(params, key: str, i: int):
    """Layer ``i`` of the stack ``params[key]``; under a mesh scope in the
    layout it runs in (``MeshScope.layer``)."""
    lp = _stack_layer(params[key], i)
    scope = spmd.current()
    if scope is None:
        return lp
    return scope.layer(lp, tree_map(lambda a, s: spmd.drop_lead(s, a.ndim, 1),
                                    params[key], scope.specs[key]))


def _embed(params, tokens):
    scope = spmd.current()
    if scope is None:
        return nn.embed(params["embed"], tokens)
    return scope.embed(params["embed"], scope.specs["embed"], tokens)


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    scope = spmd.current()
    if scope is not None:
        return _head_sharded(params, cfg, x, scope)
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return nn.linear(params["lm_head"], x).float()


def _local_cfg(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with this rank's heads under a mesh scope."""
    scope = spmd.current()
    if scope is None:
        return cfg
    if scope.kv_index is not None:
        raise ValueError(f"{cfg.name}: its {cfg.num_kv_heads} KV heads do "
                         f"not divide 'model'={scope.plan.m}")
    return scope.local(cfg)


def forward(params, cfg: ModelConfig, batch, *, train: bool = False,
            inputs_embeds: Optional[torch.Tensor] = None):
    """batch: {'tokens': (B, S)} (``inputs_embeds`` (B, S, D) in place of
    the lookup); returns (logits (B, S, V) fp32, {'moe_aux': the router
    losses summed over the MoE layers}). Under a mesh scope the params
    are this rank's slices, every rank runs the whole batch on its heads
    and d_ff columns, and ``moe_ffn`` splits the tokens itself."""
    x = _embed(params, batch["tokens"]) if inputs_embeds is None \
        else inputs_embeds
    lcfg = _local_cfg(cfg)
    positions = torch.arange(x.shape[-2], device=x.device)
    if cfg.spiking is not None:
        x = x[None].expand(cfg.spiking.time_steps, *x.shape)
    for i in range(cfg.moe.first_k_dense):
        x = _dense_layer(_layer(params, "dense_layers", i), lcfg, x,
                         positions, train)
    auxes = []
    for i in range(cfg.num_layers - cfg.moe.first_k_dense):
        x, aux = _moe_layer(_layer(params, "layers", i), lcfg, x,
                            positions, train)
        auxes.append(aux)
    if cfg.spiking is not None:
        x = x.mean(dim=0)               # rate decoding over T_s
    return _logits(params, cfg, x), {"moe_aux": torch.stack(auxes).sum()}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, batch=None,
               params=None, chunk_headroom: int = 0, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """{'layers': ..., 'dense_layers': ...}, each {'k', 'v': (n_layers,
    rows, max_len, KH, hd) in the activation dtype, 'pos': (n_layers,
    max_len) int32 tags, -1 = empty}, on ``device``; rows = T*B in spiking
    mode (as JAX sizes it), B otherwise; under a mesh scope this rank's
    heads."""
    cfg = _local_cfg(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    b = batch_size * (cfg.spiking.time_steps if cfg.spiking else 1)

    def kv(n_layers):
        shape = (n_layers, b, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev),
                "pos": torch.full((n_layers, max_len), -1,
                                  dtype=torch.int32, device=dev)}
    cache = {"layers": kv(cfg.num_layers - cfg.moe.first_k_dense)}
    if cfg.moe.first_k_dense:
        cache["dense_layers"] = kv(cfg.moe.first_k_dense)
    return cache


def _decode_attn(p, cfg: ModelConfig, x: torch.Tensor, cache_l,
                 pos: torch.Tensor) -> torch.Tensor:
    """One token a row at position ``pos`` (0-d) against this layer's
    cache, updated in place."""
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, h, pos.reshape(1))
    slot = (pos % cache_l["k"].shape[1]).reshape(1)
    cache_l["k"].index_copy_(1, slot, k.to(cache_l["k"].dtype))
    cache_l["v"].index_copy_(1, slot, v.to(cache_l["v"].dtype))
    cache_l["pos"].index_copy_(0, slot, pos.reshape(1).to(torch.int32))
    attn = nn.decode_attention(q, cache_l["k"], cache_l["v"],
                               entry_pos=cache_l["pos"], cur_pos=pos)
    return x + _row(p["wo"], attn.reshape(x.shape[0], 1, cfg.q_dim), "attn")


def _cache_layer(group, i: int):
    return {key: leaf[i] for key, leaf in group.items()}


def decode_step(params, cfg: ModelConfig, cache, tokens, pos,
                n_tok: Optional[torch.Tensor] = None):
    """tokens: (B, 1) int; pos: scalar, the position of the token in every
    row. Returns (logits (B, 1, V) fp32, cache), the cache updated in
    place. JAX's MoE decode takes no ``n_tok`` (no chunked bites, no
    per-slot state); nor does the port's."""
    if n_tok is not None:
        raise TypeError(f"{cfg.name}: MoE decode takes one token a row at "
                        f"a scalar position, no n_tok")
    if cfg.spiking is not None:
        raise ValueError(
            f"{cfg.name}: a spiking MoE has no decode step: the reference's "
            f"fails (its cache holds T*B rows, its step neither broadcasts "
            f"over T nor spikes; ROADMAP queue 3)")
    dev = params["embed"]["table"].device
    tokens = torch.as_tensor(tokens, device=dev)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev).reshape(())
    x = _embed(params, tokens)
    lcfg = _local_cfg(cfg)
    for i in range(cfg.moe.first_k_dense):
        lp = _layer(params, "dense_layers", i)
        x = _decode_attn(lp, lcfg, x, _cache_layer(cache["dense_layers"], i),
                         pos)
        h = nn.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + _mlp(lp["mlp"], h, cfg.act)
    for i in range(cfg.num_layers - cfg.moe.first_k_dense):
        lp = _layer(params, "layers", i)
        x = _decode_attn(lp, lcfg, x, _cache_layer(cache["layers"], i), pos)
        h = nn.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        y, _ = moe_ffn(lp["moe"], h, lcfg)
        x = x + y
    return _logits(params, cfg, x), cache
