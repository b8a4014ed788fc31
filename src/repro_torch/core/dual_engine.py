"""Dual-engine latency-hiding pipeline schedule (paper Section III-C,
Eq. 3/4) — analytic model and measurement consumer.

Port copy of ``repro.core.dual_engine`` (pure Python, no framework): the
discrete-event model of the sparse / binary engine overlap (Fig. 5) and
:func:`fused_step_metrics`, which turns the layer program's measured
``(H, 8, n_l_blocks)`` executed sub-block counts
(``kernels/fused_layer.fused_layer``, fused or pipelined) or the SSA
bundle's ``(H, 4)`` counts (``kernels/fused_ssa.fused_ssa``) into a
hidden-fraction / utilization report. The pipelined schedule is the one
place where ``pipeline`` changes a number: its counts equal the fused
schedule's, and the event model splits each phase over ``t_steps``
chained iterations (the timestep wavefront), so the next timestep's
q/k/v fill the sparse engine's stall windows. ``chip_smoke.py`` logs it
on one layer call's counts; the values equal the JAX module's exactly on
the same inputs (``tests/test_torch_dual_engine.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class EngineParallelism:
    """Hardware parallelism knobs (Table II)."""
    P_Ts: int = 2
    P_Fx: int = 4
    P_Ci: int = 16
    P_Co: int = 64
    # binary engine systolic array + inner-product width
    P_Bm: int = 4
    P_Bn: int = 4
    P_Bk: int = 32

    @property
    def P_s(self) -> int:
        return self.P_Ts * self.P_Fx * self.P_Ci * self.P_Co

    @property
    def P_b(self) -> int:
        return self.P_Bm * self.P_Bn * self.P_Bk


@dataclasses.dataclass(frozen=True)
class AttentionWorkload:
    """Per-head attention workload (Eq. 3)."""
    T_s: int
    F_h: int
    F_w: int
    C_i: int          # embedding dim d
    P_Co: int         # output-channel tile == per-head dim in the schedule
    heads: int = 8

    @property
    def L(self) -> int:
        return self.F_h * self.F_w

    def W_s(self) -> int:
        """Sparse-engine work per head per projection (MACs)."""
        return self.T_s * self.L * self.C_i * self.P_Co

    def W_b(self) -> int:
        """Binary-engine work per head per attention matmul (MACs)."""
        return self.T_s * self.L * self.L * self.P_Co


def required_binary_parallelism(w: AttentionWorkload, p: EngineParallelism) -> float:
    """Eq. 4: P_b ~= 2/3 * (Fh*Fw / Ci) * P_s for balanced overlap."""
    return 2.0 / 3.0 * (w.L / w.C_i) * p.P_s


# Per-head timing inputs: a scalar (every op identical — the original
# two-scalar model), or a per-head sequence whose entries are scalars or
# (Q, K, V) triples (sparse) / (QK^T, QK^TV) pairs (binary).
PerHead = Union[float, Sequence]


def _sparse_triples(ts: PerHead, heads: int) -> List[Tuple[float, ...]]:
    if not isinstance(ts, Sequence):
        return [(float(ts),) * 3] * heads
    if len(ts) != heads:
        raise ValueError(f"per-head sparse timings: got {len(ts)} entries "
                         f"for {heads} heads")
    return [(float(e),) * 3 if not isinstance(e, Sequence)
            else tuple(float(x) for x in e) for e in ts]


def _binary_pairs(tb: PerHead, heads: int) -> List[Tuple[float, ...]]:
    if not isinstance(tb, Sequence):
        return [(float(tb),) * 2] * heads
    if len(tb) != heads:
        raise ValueError(f"per-head binary timings: got {len(tb)} entries "
                         f"for {heads} heads")
    return [(float(e),) * 2 if not isinstance(e, Sequence)
            else tuple(float(x) for x in e) for e in tb]


def _event_schedule(ts: PerHead, tb: PerHead, heads: int
                    ) -> Tuple[List[tuple], List[tuple], float, float]:
    """Core event loop shared by the analytic and measured schedules:
    the sparse engine serially computes Q_h, K_h, V_h per head (``ts``
    each); the binary engine computes ``QK^T_h`` once Q_h,K_h are done
    and ``QK^T V_h`` once V_h is done (``tb`` each). ``ts``/``tb`` are
    scalars or per-head sequences (see :data:`PerHead`); the scalar path
    is numerically pinned to the original two-scalar model."""
    trips = _sparse_triples(ts, heads)
    pairs = _binary_pairs(tb, heads)
    sparse_events, binary_events = [], []
    t_sparse = 0.0
    qk_done = {}
    v_done = {}
    for h in range(heads):
        for name, dt in zip(("Q", "K", "V"), trips[h]):
            sparse_events.append((f"{name}{h}", t_sparse, t_sparse + dt))
            t_sparse += dt
            if name == "K":
                qk_done[h] = t_sparse
            if name == "V":
                v_done[h] = t_sparse
    t_bin = 0.0
    for h in range(heads):
        t_qk, t_qkv = pairs[h]
        start = max(t_bin, qk_done[h])
        binary_events.append((f"QK^T {h}", start, start + t_qk))
        t_bin = start + t_qk
        start = max(t_bin, v_done[h])
        binary_events.append((f"QK^TV {h}", start, start + t_qkv))
        t_bin = start + t_qkv

    total_overlapped = max(t_sparse, t_bin if binary_events else 0.0)
    if not isinstance(tb, Sequence):
        # the original scalar expression, verbatim (float-op-for-float-op:
        # the scalar path is pinned numerically unchanged)
        total_serial = t_sparse + 2 * float(tb) * heads
    else:
        total_serial = t_sparse + sum(t_qk + t_qkv
                                      for t_qk, t_qkv in pairs)
    return sparse_events, binary_events, total_overlapped, total_serial


def pipeline_schedule(w: AttentionWorkload, p: EngineParallelism,
                      sparsity: float = 0.0
                      ) -> Tuple[List[tuple], List[tuple], int, int]:
    """Discrete-event schedule of the latency-hiding pipeline (Fig. 5).

    Op latencies come from the analytic MAC model (Eq. 3 work over
    Table II parallelism; sparse throughput scales with input density
    when skipping is on). Returns (sparse_events, binary_events,
    total_overlapped, total_serial); events are (name, start, end) in
    cycles.
    """
    ts = w.W_s() / (p.P_s / max(1e-9, 1.0 - sparsity))  # sparse op latency
    tb = w.W_b() / p.P_b                                # binary op latency
    se, be, overlapped, serial = _event_schedule(ts, tb, w.heads)
    return se, be, math.ceil(overlapped), math.ceil(serial)


def measured_schedule(sparse_op_us: PerHead, binary_op_us: PerHead,
                      heads: int = 8
                      ) -> Tuple[List[tuple], List[tuple], float, float]:
    """Fig. 5 schedule fed with *measured* engine timings instead of the
    analytic MAC model. Each input is a scalar
    (all heads/ops identical) or a per-head sequence — entries scalars or
    (Q, K, V) triples / (QK^T, QK^TV) pairs, e.g. derived from the fused
    kernel's per-phase executed-step counts. Events are in the same unit
    as the inputs; returns (sparse_events, binary_events,
    total_overlapped, total_serial).
    """
    if not isinstance(sparse_op_us, Sequence):
        sparse_op_us = float(sparse_op_us)
    if not isinstance(binary_op_us, Sequence):
        binary_op_us = float(binary_op_us)
    return _event_schedule(sparse_op_us, binary_op_us, heads)


def measured_overlap_efficiency(sparse_op_us: PerHead,
                                binary_op_us: PerHead,
                                heads: int = 8) -> float:
    """Fraction of the serial dual-engine latency the overlap hides,
    from measured timings: 1 - overlapped/serial."""
    _, _, overlapped, serial = measured_schedule(sparse_op_us,
                                                 binary_op_us, heads)
    if serial <= 0:
        return 0.0
    return 1.0 - overlapped / serial


def schedule_metrics(sparse_op_us: PerHead, binary_op_us: PerHead,
                     heads: int = 8) -> Dict[str, float]:
    """Hidden fraction *and* per-engine utilization of the Fig. 5
    schedule: utilization is each engine's busy time over the overlapped
    makespan (1.0 = that engine never stalls; the paper sizes ``P_B*`` so
    both stay near 1 — Eq. 4)."""
    se, be, overlapped, serial = measured_schedule(sparse_op_us,
                                                   binary_op_us, heads)
    sparse_busy = sum(e - s for _, s, e in se)
    binary_busy = sum(e - s for _, s, e in be)
    return {
        "overlapped": overlapped,
        "serial": serial,
        "hidden_fraction": 0.0 if serial <= 0 else 1.0 - overlapped / serial,
        "sparse_util": 0.0 if overlapped <= 0 else sparse_busy / overlapped,
        "binary_util": 0.0 if overlapped <= 0 else binary_busy / overlapped,
    }


LAYER_PHASE_NAMES = ("q", "k", "v", "qkt", "qktv", "wo", "up", "down")


def _interval_overlap(binary_events: List[tuple],
                      sparse_events: List[tuple]) -> float:
    """Total binary busy time that lies under sparse busy time."""
    total = 0.0
    for _, b0, b1 in binary_events:
        for _, s0, s1 in sparse_events:
            lo, hi = max(b0, s0), min(b1, s1)
            if hi > lo:
                total += hi - lo
    return total


def layer_event_schedule(macs: Dict[str, List[float]], heads: int,
                         iters: int = 1
                         ) -> Tuple[List[tuple], List[tuple]]:
    """Discrete-event schedule of the *layer program* (the fused-layer
    grid of ``kernels/fused_layer.py``): the sparse engine walks the
    phases in the kernel's phase-major grid order (q, k, v over all
    heads, then wo, up, down), the binary engine runs qkt/qktv as their
    operands land, and ``wo`` of head h stalls on ``qktv`` of head h
    (the context dependency). ``macs[phase][h]`` is the executed-MAC
    duration of that (phase, head) work item.

    ``iters > 1`` models the pipeline grid's timestep wavefront: the
    per-phase work splits evenly over ``iters`` chained iterations, so
    iteration i+1's q/k/v tiles fill the sparse-engine stall windows
    and overlap iteration i's binary tail — the reason the pipeline
    mode's measured hidden fraction exceeds the fused grid's.

    Returns (sparse_events, binary_events) as (name, start, end) lists.
    """
    se: List[tuple] = []
    be: List[tuple] = []
    t_s = 0.0
    t_b = 0.0
    frac = 1.0 / iters
    for it in range(iters):
        k_done: Dict[int, float] = {}
        v_done: Dict[int, float] = {}
        ctx_done: Dict[int, float] = {}
        for ph in ("q", "k", "v"):
            for h in range(heads):
                dt = macs[ph][h] * frac
                se.append((f"{ph}{h}@{it}", t_s, t_s + dt))
                t_s += dt
                if ph == "k":
                    k_done[h] = t_s
                elif ph == "v":
                    v_done[h] = t_s
        for h in range(heads):
            dt = macs["qkt"][h] * frac
            start = max(t_b, k_done[h])
            be.append((f"qkt{h}@{it}", start, start + dt))
            t_b = start + dt
        for h in range(heads):
            dt = macs["qktv"][h] * frac
            start = max(t_b, v_done[h])
            be.append((f"qktv{h}@{it}", start, start + dt))
            t_b = start + dt
            ctx_done[h] = t_b
        for h in range(heads):
            dt = macs["wo"][h] * frac
            start = max(t_s, ctx_done[h])
            se.append((f"wo{h}@{it}", start, start + dt))
            t_s = start + dt
        for ph in ("up", "down"):
            for h in range(heads):
                dt = macs[ph][h] * frac
                se.append((f"{ph}{h}@{it}", t_s, t_s + dt))
                t_s += dt
    return se, be


def _layer_step_metrics(counts, *, seq, k_dim, head_dim, t_steps, batch,
                        d_model, d_ff, l_block, sparse, c_block,
                        pipeline) -> Dict[str, float]:
    """The occupancy-map consumer: per-(head, phase, L-block) executed
    sub-block counts from the fused-layer kernel -> executed-MAC phase
    durations -> layer event schedule -> *binary-hidden fraction* (the
    share of binary-engine busy time that runs under sparse-engine busy
    time). Unlike the SSA-only makespan ratio, this is the quantity the
    layer program actually improves: the MLP tail (wo/up/down) gives the
    sparse engine work to run *under* the binary tail, and the pipeline
    grid additionally folds the next timestep's q/k/v into the wo stall
    windows."""
    cnt = [[[int(c) for c in lbrow] for lbrow in row] for row in counts]
    heads = len(cnt)
    nlb = len(cnt[0][0])
    rows = [min(l_block, seq - lb * l_block) for lb in range(nlb)]
    ffc = d_ff // heads
    decoded = sparse == "decoded"
    proj_k = c_block if decoded else k_dim
    unit = {"q": proj_k * head_dim, "k": proj_k * head_dim,
            "v": proj_k * head_dim,
            "qkt": seq * head_dim, "qktv": seq * head_dim,
            "wo": head_dim * d_model, "up": d_model * ffc,
            "down": ffc * d_model}
    macs = {ph: [float(sum(cnt[h][p][lb] * rows[lb]
                           for lb in range(nlb)) * unit[ph])
                 for h in range(heads)]
            for p, ph in enumerate(LAYER_PHASE_NAMES)}
    iters = t_steps if pipeline else 1
    se, be = layer_event_schedule(macs, heads, iters)
    sparse_busy = sum(e - s for _, s, e in se)
    binary_busy = sum(e - s for _, s, e in be)
    makespan = max([e for _, _, e in se + be], default=0.0)
    hidden = _interval_overlap(be, se)
    qkt_ev = [ev for ev in be if ev[0].startswith("qkt") and
              not ev[0].startswith("qktv")]
    qktv_ev = [ev for ev in be if ev[0].startswith("qktv")]
    qkt_busy = sum(e - s for _, s, e in qkt_ev)
    qktv_busy = sum(e - s for _, s, e in qktv_ev)
    executed = {ph: sum(cnt[h][p][lb] for h in range(heads)
                        for lb in range(nlb))
                for p, ph in enumerate(LAYER_PHASE_NAMES)}
    per_block = t_steps * batch * heads * nlb
    possible = {ph: per_block for ph in LAYER_PHASE_NAMES}
    if decoded:
        nc = -(-k_dim // c_block)
        for ph in ("q", "k", "v"):
            possible[ph] = per_block * nc
    tot_exec = sum(executed.values())
    tot_poss = sum(possible.values())
    return {
        "heads": heads,
        "phases": len(LAYER_PHASE_NAMES),
        "l_blocks": nlb,
        "pipeline_iters": iters,
        "executed_steps": tot_exec,
        "possible_steps": tot_poss,
        "step_reduction": 0.0 if tot_poss == 0
        else 1.0 - tot_exec / tot_poss,
        "sparse_busy": sparse_busy,
        "binary_busy": binary_busy,
        "makespan": makespan,
        "sparse_util": 0.0 if makespan <= 0 else sparse_busy / makespan,
        "binary_util": 0.0 if makespan <= 0 else binary_busy / makespan,
        # the binary-hidden fraction: binary busy time overlapped by
        # sparse busy time, over binary busy time
        "hidden_fraction": 0.0 if binary_busy <= 0
        else hidden / binary_busy,
        "qkt_hidden_fraction": 0.0 if qkt_busy <= 0
        else _interval_overlap(qkt_ev, se) / qkt_busy,
        "qktv_hidden_fraction": 0.0 if qktv_busy <= 0
        else _interval_overlap(qktv_ev, se) / qktv_busy,
        **{f"executed_{ph}": executed[ph] for ph in LAYER_PHASE_NAMES},
    }


def fused_step_metrics(counts, *, seq: int, k_dim: int, head_dim: int,
                       t_steps: int, batch: int, d_model: int = None,
                       d_ff: int = None, l_block: int = None,
                       sparse: str = "tile", c_block: int = None,
                       pipeline: bool = False) -> Dict[str, float]:
    """Measured overlap report from the fused kernel's executed-step
    counts — either the SSA bundle's ``(H, 4)`` int32 counts
    (``kernels/fused_ssa.fused_ssa``: executed Q/K/V projection dots and
    attention dots per head) or the layer program's ``(H, 8, n_l_blocks)``
    occupancy map (``kernels/fused_layer.fused_layer``: executed
    sub-blocks per head, phase and L-block — dispatched on the counts'
    rank; the layer path needs ``d_model``/``d_ff``/``l_block`` and, for
    ``sparse='decoded'``, ``c_block``).

    This is the "measured, not modeled" hidden fraction: op durations in
    the Fig. 5 schedule are the *executed* MACs of each phase — a
    projection sub-step the kernel skipped (all-dark spike slab) simply
    isn't there — with exact per-dot weights (projection dot = L*K*hd
    MACs, attention dot = L*L*hd). Deterministic for a fixed input.
    """
    ndim = counts.ndim if hasattr(counts, "ndim") else \
        (3 if isinstance(counts[0][0], (list, tuple)) else 2)
    if ndim == 3:
        return _layer_step_metrics(
            counts, seq=seq, k_dim=k_dim, head_dim=head_dim,
            t_steps=t_steps, batch=batch, d_model=d_model, d_ff=d_ff,
            l_block=l_block, sparse=sparse, c_block=c_block,
            pipeline=pipeline)
    rows = [[int(c) for c in row] for row in counts]
    heads = len(rows)
    w_proj = seq * k_dim * head_dim          # MACs per executed proj dot
    w_attn = seq * seq * head_dim            # MACs per executed attn dot
    sparse = [(r[0] * w_proj, r[1] * w_proj, r[2] * w_proj) for r in rows]
    binary = [(r[3] // 2 * w_attn, (r[3] - r[3] // 2) * w_attn)
              for r in rows]
    m = schedule_metrics(sparse, binary, heads)
    exec_q = sum(r[0] for r in rows)
    exec_k = sum(r[1] for r in rows)
    exec_v = sum(r[2] for r in rows)
    exec_attn = sum(r[3] for r in rows)
    possible_proj = 3 * t_steps * batch * heads
    possible_attn = 2 * t_steps * batch * heads
    executed = exec_q + exec_k + exec_v + exec_attn
    possible = possible_proj + possible_attn
    m.update({
        "heads": heads,
        "executed_q": exec_q, "executed_k": exec_k, "executed_v": exec_v,
        "executed_attn": exec_attn,
        "possible_steps": possible,
        "executed_steps": executed,
        # sequential baseline executes every sub-step back-to-back; the
        # fused step both *skips* dark projection slabs and *hides*
        # binary work behind sparse work — this is the skip half:
        "step_reduction": 0.0 if possible == 0
        else 1.0 - executed / possible,
        "proj_skip_fraction": 0.0 if possible_proj == 0
        else 1.0 - (exec_q + exec_k + exec_v) / possible_proj,
    })
    return m


def pipeline_efficiency(w: AttentionWorkload, p: EngineParallelism,
                        sparsity: float = 0.0) -> float:
    """Fraction of attention latency hidden: 1 -> perfect (O(3TsLd^2))."""
    _, _, overlapped, serial = pipeline_schedule(w, p, sparsity)
    ideal = 3 * w.heads * (w.W_s() / (p.P_s / max(1e-9, 1.0 - sparsity)))
    if overlapped <= 0:
        return 1.0
    return min(1.0, ideal / overlapped)


def complexity_reduction(w: AttentionWorkload) -> Tuple[int, int]:
    """(serial, overlapped) op counts: O(3TsLd^2 + 2TsL^2 d) -> O(3TsLd^2).

    Uses d == heads * P_Co as the full embedding dim.
    """
    d = w.C_i
    serial = 3 * w.T_s * w.L * d * d + 2 * w.T_s * w.L * w.L * d
    overlapped = 3 * w.T_s * w.L * d * d
    return serial, overlapped
