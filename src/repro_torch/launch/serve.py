"""Serving orchestrator: continuous batching with per-slot state and
chunked prefill (the port of ``repro.launch.serve``, unsharded).

* per-slot state: every cache slot carries its own timeline (positions
  ``pos: (B,)``, validity tags ``(n_layers, B, s)``), so a finished
  sequence frees its slot and a queued request claims it mid-flight; the
  freed slot's tags are invalidated at admission;
* chunked prefill: a prompt fills its slot's cache in ``chunk``-sized
  bites through the same decode step the generating slots ride (their
  rows are padding-masked through ``n_tok``), the width chosen per wave
  by the popcount-aware policy of :func:`choose_chunk`;
* greedy sampling (argmax);
* the dense decoders (``--arch h2o-danube-3-4b``, ``gemma3-12b``,
  ``nemotron-4-15b``, ``granite-20b``) decode against caches in the
  activation dtype; sliding-window layers against rings of window +
  chunk - 1 entries, so a bite never evicts what its own queries see;
* llava-next-mistral-7b (the vlm family) serves text continuations
  through its mistral backbone's decode, as a dense decoder; the other
  token families (MoE, rwkv, hybrid, encdec) carry no per-slot state and
  are refused, as in JAX: they decode through
  ``launch/steps.build_serve_step``;
* the spiking LM decodes against the bit-packed spike KV cache, and the
  server reports its footprint against the unpacked layout;
* ``--quantize int8|int4`` quantizes the linears at load
  (``repro_torch.quant``); the decode path's products then run
  ``dense_quant_linear`` (the prefill step's layers run the fused layer
  program's rope family on the card) and the server reports the weight
  footprint;
* mesh-sharded decode: given a ``launch.mesh.Mesh`` (one rank a mesh
  position), slots shard over 'data' and heads / d_ff / vocab over
  'model' by the ``parallel/rules.py`` tables; every rank holds its
  slices of the params and the cache, runs the same host loop and
  samples the same tokens (the logits are gathered over the mesh), and
  only rank 0 prints. ``--mesh DATAxMODEL`` starts the ranks itself
  (``launch.mesh.launch``): NCCL where each has a GPU of its own, gloo
  where they share one (or with ``--device cpu``).

Run: ``PYTHONPATH=src python -m repro_torch.launch.serve --arch
spikingformer-lm --quantize int8`` (or ``--arch h2o-danube-3-4b
--quantize int8 --requests 2 --prompt-len 5000 --max-len 6000 --chunk
1024``) on the GPU (the published config), or with ``--smoke --device
cpu`` on the CPU; ``--mesh 2x2`` on four ranks.
"""
from __future__ import annotations

import argparse
import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import RunShape
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import Mesh, launch, parse_mesh
from repro_torch.models import registry
from repro_torch.parallel import rules as prules
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import (local_shape, shard_put,
                                           spec_axes, spec_entries)
from repro_torch.sim import decoder_sim
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (L,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    # full logits row behind every sampled token (trace_logits=True)
    logit_trace: List[np.ndarray] = field(default_factory=list)
    done: bool = False


def choose_chunk(remaining_prompt: int, n_decoding: int, max_chunk: int,
                 *, lanes: int = 4) -> int:
    """Prefill chunk width by the paper's Eq. 6 composite metric over the
    decoder model's input-tracker latency: the backlog of R tokens in
    C-token bites is a stream of C-bit words for one worker whose lane
    budget is ``lanes`` per prefilling slot scaled by the decode riders;
    F = 1 / (C * D^2), argmax over power-of-two C."""
    if remaining_prompt <= 0 or max_chunk <= 1:
        return 1
    g_eff = lanes * (1 + n_decoding)
    best_c, best_f = 1, -1.0
    c = 1
    while c <= max_chunk:
        d = _drain_latency(remaining_prompt, c, g_eff)
        f = 1.0 / (c * float(d) * float(d))
        if f > best_f:
            best_c, best_f = c, f
        c *= 2
    return best_c


@functools.lru_cache(maxsize=65536)
def _drain_latency(remaining: int, chunk: int, g_eff: int) -> int:
    """Simulated drain latency of the bite stream (memoized: the policy
    runs on the host every wave over the same grid)."""
    n_full, rem = divmod(remaining, chunk)
    pc = np.full(n_full + (1 if rem else 0), chunk, np.int64)
    if rem:
        pc[-1] = rem
    dcfg = decoder_sim.DecoderConfig(p_ci=chunk, m_lanes=g_eff, p_wo=1)
    return decoder_sim.simulate_latency(pc, dcfg)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class BatchedServer:
    """Slot-based continuous batching over a fixed cache batch size.

    ``chunk``: prefill bite width; 0 = auto (:func:`choose_chunk` per
    wave). Wave widths are rounded up to powers of two, as in JAX (where
    that bounds the compiled shapes). ``device``: where the cache lives
    and the step runs (the GPU by default; ``params`` must be there).
    ``mesh``: a ``launch.mesh.Mesh`` with ('data', 'model') axes, built
    inside the ranks; ``params`` is then the whole tree, on any device
    (the host, so that no rank's device ever holds it whole), of which
    this rank copies its slices (``param_specs``) to its device; the
    cache holds this rank's slots and heads, and the step runs on the
    mesh's device."""

    def __init__(self, cfg, params, slots: int, max_len: int, *,
                 chunk: int = 0, mesh=None, trace_logits: bool = False,
                 device: DeviceLike = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a launch.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if not registry.supports_slots(cfg):
            raise ValueError(
                f"{cfg.name} ({cfg.family}) has no per-slot decode state; "
                f"continuous batching needs a slotted-decode family "
                f"({sorted(registry.SLOTTED_DECODE)})")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        cap = max_len if cfg.attn_type == "full" else min(max_len,
                                                          cfg.window)
        self.max_chunk = max(1, min(chunk if chunk > 0 else cap, cap))
        self.fixed_chunk = chunk > 0
        self.trace_logits = trace_logits
        self.params = params
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.headroom = 0 if cfg.attn_type == "full" else self.max_chunk - 1
        self.scope = self.param_specs = self.cache_specs = None
        if mesh is None:
            self.cache = registry.init_cache(cfg, slots, max_len,
                                             chunk_headroom=self.headroom,
                                             device=self.device)
        else:
            self._shard(params)
        self._step = steps_lib.build_batched_serve_step(cfg,
                                                        device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, np.int64)
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.waves = 0

    def _shard(self, params):
        """The mesh's layout: param and cache specs from the rules, this
        rank's param slices, its slots' and heads' cache (checked against
        the cache spec's local shape), and the model code's scope."""
        cfg, mesh = self.cfg, self.mesh
        shape = RunShape("serve", self.max_len, self.slots, "decode")
        self.param_specs = prules.params_partition(
            cfg, tree_map(lambda a: a.to("meta"), params), mesh)
        full = registry.init_cache(cfg, self.slots, self.max_len,
                                   chunk_headroom=self.headroom,
                                   device="meta")
        self.cache_specs = prules.cache_partition(cfg, shape, mesh, full)
        for spec in tree_leaves(self.cache_specs):
            if "data" in spec_axes(spec_entries(spec, 3)[2]):
                raise ValueError(
                    f"{self.slots} slots on data={mesh.shape['data']}: the "
                    f"cache spec shards the sequence (long-context KV), "
                    f"which the server does not run; give it at least as "
                    f"many slots as 'data'")
        dp = prules.batch_axes(shape, mesh)
        self.scope = spmd.MeshScope(mesh, cfg, self.param_specs, dp)
        self.rows = self.scope.rows(self.slots)
        self.params = shard_put(params, self.param_specs, mesh)
        self.cache = registry.init_cache(
            self.scope.local_cfg, self.rows.stop - self.rows.start,
            self.max_len, chunk_headroom=self.headroom, device=self.device)
        want = tree_map(lambda a, s: local_shape(a.shape, s, mesh), full,
                        self.cache_specs)
        got = tree_map(lambda a: tuple(a.shape), self.cache)
        if want != got:
            raise AssertionError(f"local cache {got} != its spec's {want}")

    def _bytes(self, tree, specs=None) -> Dict[str, int]:
        """{'total': the whole (logical) tree's bytes, 'rank': this rank's
        share} of a tree of this rank's leaves under ``specs``."""
        def n(leaf):
            return leaf.numel() * leaf.element_size()

        def copies(leaf, spec):
            k = 1
            for part in spec_entries(spec, leaf.ndim):
                for a in spec_axes(part):
                    k *= self.mesh.shape.get(a, 1)
            return k
        rank = sum(n(leaf) for leaf in tree_leaves(tree))
        if specs is None:
            return {"total": rank, "rank": rank}
        total = sum(n(leaf) * copies(leaf, spec) for leaf, spec in zip(
            tree_leaves(tree), tree_leaves(specs)))
        return {"total": total, "rank": rank}

    def param_bytes(self) -> Dict[str, int]:
        """The params' bytes: the whole tree's and this rank's share."""
        return self._bytes(self.params, self.param_specs)

    def kv_cache_stats(self) -> Dict[str, float]:
        """Measured KV footprint; 'compression' is the ratio against the
        same entries unpacked in the activation dtype (32x a word on the
        packed spiking path, 1.0 otherwise). On a mesh 'kv_bytes' is the
        whole cache's (what the unsharded server holds) and
        'kv_bytes_rank' this rank's share."""
        pick = lambda tree: {g: {k: v for k, v in leaves.items()
                                 if k in ("k", "v")}
                             for g, leaves in tree.items()}
        kv = tree_leaves(pick(self.cache))
        got = self._bytes(pick(self.cache), None if self.mesh is None
                          else pick(self.cache_specs))
        kv_bytes = got["total"]
        act_bytes = getattr(torch, self.cfg.dtype).itemsize
        packed = any(leaf.dtype == torch.int32 for leaf in kv)
        if packed:
            words = -(-self.cfg.head_dim // 32)
            unpacked = kv_bytes // 4 // words * self.cfg.head_dim * act_bytes
        else:
            unpacked = kv_bytes
        stats = {"kv_bytes": kv_bytes, "packed": packed,
                 "compression": unpacked / max(1, kv_bytes)}
        if self.mesh is not None:
            stats["kv_bytes_rank"] = got["rank"]
        return stats

    def submit(self, req: Request):
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"exceeds cache capacity max_len={self.max_len}")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be "
                             f">= 1, got {req.max_new_tokens}")
        self.queue.append(req)

    def _admit(self):
        fresh = np.zeros(self.slots, bool)
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                self.slot_req[s] = self.queue.pop(0)
                self.slot_pos[s] = 0
                fresh[s] = True
        if fresh.any():
            # a re-admitted slot must not attend over the previous
            # occupant's K/V: its validity tags go to -1 (on a mesh, in
            # this rank's slots)
            mine = fresh if self.scope is None else fresh[self.rows]
            registry.invalidate_slots(self.cfg, self.cache,
                                      torch.from_numpy(mine))

    def step(self) -> bool:
        """One wave: admit queued requests into free slots, issue a
        prefill bite or one decode token per active slot, run the batched
        step, sample, retire finished sequences."""
        self._admit()
        active = [s for s in range(self.slots) if self.slot_req[s]]
        if not active:
            return False
        backlog = sum(max(0, len(self.slot_req[s].prompt)
                          - self.slot_pos[s]) for s in active)
        n_decoding = sum(self.slot_pos[s] >= len(self.slot_req[s].prompt)
                         for s in active)
        chunk = self.max_chunk if self.fixed_chunk else \
            choose_chunk(int(backlog), int(n_decoding), self.max_chunk)
        n_tok = np.zeros(self.slots, np.int32)
        for s in active:
            req, p = self.slot_req[s], int(self.slot_pos[s])
            if p < len(req.prompt):
                n_tok[s] = min(chunk, len(req.prompt) - p,
                               self.max_len - p)
            else:
                n_tok[s] = 1
        width = _next_pow2(int(n_tok.max()))
        tokens = np.zeros((self.slots, width), np.int32)
        for s in active:
            req, p, n = self.slot_req[s], int(self.slot_pos[s]), int(n_tok[s])
            if p < len(req.prompt):
                tokens[s, :n] = req.prompt[p:p + n]
            else:
                tokens[s, 0] = req.generated[-1]
        with spmd.use_mesh(self.scope):
            logits, self.cache = self._step(
                self.params, self.cache, torch.from_numpy(tokens),
                torch.from_numpy(self.slot_pos.astype(np.int32)),
                torch.from_numpy(n_tok))
        nxt = logits.argmax(dim=-1).cpu().numpy()        # (slots, width)
        for s in active:
            req, n = self.slot_req[s], int(n_tok[s])
            self.slot_pos[s] += n
            p = int(self.slot_pos[s])
            if p >= len(req.prompt):
                req.generated.append(int(nxt[s, n - 1]))
                if self.trace_logits:
                    req.logit_trace.append(logits[s, n - 1].cpu().numpy())
            # position max_len - 1 is the last usable entry; the token
            # sampled from it is kept, it just cannot be fed back
            if len(req.generated) >= req.max_new_tokens or \
                    p >= self.max_len:
                req.done = True
                self.completed.append(req)
                self.slot_req[s] = None
        self.waves += 1
        return True

    def run(self) -> int:
        """Drain the queue; returns the total wave count."""
        while self.step():
            pass
        return self.waves


def load(args, dev: torch.device):
    """The CLI's model: (cfg, params drawn from seed 0 on ``dev`` and
    quantized as ``--quantize`` asks, the weight footprint report or
    None)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if not registry.has_decode(cfg):
        raise SystemExit(f"{args.arch} has no decode step")
    params = registry.init(cfg, 0, device=dev)
    wrep = None
    if args.quantize != "none":
        from repro_torch.core.engine import EngineConfig
        from repro_torch.quant import footprint_report, quantize_tree
        qparams = quantize_tree(params, args.quantize)
        wrep = footprint_report(params, qparams)
        eng = cfg.engine if cfg.engine is not None else EngineConfig()
        cfg = cfg.replace(engine=eng.replace(weights=args.quantize))
        params = qparams
    return cfg, params, wrep


def serve(args, mesh: Optional[Mesh] = None, model=None
          ) -> Dict[str, object]:
    """The CLI's run on one process, or on one rank of ``mesh`` (only
    rank 0 prints); ``model``: :func:`load`'s result, made here when
    None. Returns the generations and the report's numbers."""
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    cfg, params, wrep = model if model is not None else load(args, dev)
    server = BatchedServer(cfg, params, args.slots, args.max_len,
                           chunk=args.chunk, device=dev, mesh=mesh)
    del params
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        server.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                       args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))
    kv = server.kv_cache_stats()
    pb = server.param_bytes()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else str(dev)
    on = "" if mesh is None else (
        f", mesh={args.mesh} ({mesh.backend}, {mesh.devices.size} ranks on "
        f"{where}): {kv['kv_bytes_rank']/1024:.1f} KiB of it and "
        f"{pb['rank']/1024:.1f} of {pb['total']/1024:.1f} KiB of params "
        f"a rank")
    say(f"[serve] kv cache {kv['kv_bytes']/1024:.1f} KiB "
        f"(packed={kv['packed']}, {kv['compression']:.0f}x vs unpacked)"
        + on)
    if wrep is not None:
        say(f"[serve] weights {wrep['quant_weight_bytes']/1024:.1f} KiB "
            f"({args.quantize}): {wrep['compression']:.2f}x vs "
            f"{cfg.dtype} linears "
            f"({wrep['total_compression']:.2f}x whole tree)")
    t0 = time.perf_counter()
    steps = server.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_gen = sum(len(r.generated) for r in server.completed)
    n_pre = sum(len(r.prompt) for r in server.completed)
    say(f"[serve] {len(server.completed)} requests, {n_gen} generated "
        f"(+{n_pre} prompt) tokens, {steps} waves in {dt:.2f}s "
        f"({(n_gen + n_pre)/dt:.1f} tok/s on {where}"
        + ("" if mesh is None else f", {mesh.backend}") + ")")
    for r in server.completed[:3]:
        say(f"  req {r.rid}: {r.generated}")
    return {"generated": {r.rid: r.generated for r in server.completed},
            "seconds": dt, "waves": steps, "kv": kv, "params": pb}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="spikingformer-lm",
                    choices=list(ALL_ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced SMOKE config (default: published)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=0,
                    help="prefill chunk width; 0 = popcount-aware policy")
    ap.add_argument("--mesh", default="",
                    help="DATAxMODEL serving mesh, e.g. 2x2: starts that "
                         "many ranks ('' = unsharded)")
    ap.add_argument("--quantize", default="none",
                    choices=["none", "int8", "int4"],
                    help="quantize linear weights at load; reports the "
                         "measured footprint compression")
    args = ap.parse_args(argv)
    if not args.mesh:
        return serve(args)
    d, m = parse_mesh(args.mesh)
    dev = resolve_device(args.device)
    # drawn once, where the unsharded run draws it (the same tokens), and
    # handed to the ranks in host memory: a rank's device holds only its
    # slices, never the whole tree
    cfg, params, wrep = load(args, dev)
    host = tree_map(lambda a: a.cpu(), params)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launch(_serve_rank, d, m, args, (cfg, host, wrep), device=dev)


def _serve_rank(mesh: Mesh, args, model):
    return serve(args, mesh, model)


if __name__ == "__main__":
    main()
