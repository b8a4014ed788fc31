"""The port's copy of ``core/dual_engine`` (the Fig. 5 schedule model and
the consumer of the layer program's counts) returns exactly what
``repro.core.dual_engine`` returns on the same inputs: fixed workloads,
fixed count maps, and the counts of a port pipelined layer call."""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import dual_engine as JD  # noqa: E402
from repro_torch.core import dual_engine as TD  # noqa: E402
from repro_torch.kernels import fused_layer as TFL  # noqa: E402

from _torch_helpers import layer_ops, to_torch  # noqa: E402

WORKLOADS = [dict(T_s=4, F_h=8, F_w=8, C_i=256, P_Co=32),
             dict(T_s=4, F_h=14, F_w=14, C_i=512, P_Co=64, heads=8),
             dict(T_s=2, F_h=5, F_w=3, C_i=16, P_Co=8, heads=2)]


def _counts(heads, nlb, seed):
    """A fixed (H, 8, nlb) count map with some zero sub-blocks."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 9, (heads, 8, nlb)).astype(np.int32)
    c[0, 3] = 0
    return c


@pytest.mark.parametrize("w", range(len(WORKLOADS)))
@pytest.mark.parametrize("sparsity", [0.0, 0.6])
def test_analytic_schedule_matches_jax(w, sparsity):
    jw, tw = JD.AttentionWorkload(**WORKLOADS[w]), \
        TD.AttentionWorkload(**WORKLOADS[w])
    jp, tp = JD.EngineParallelism(), TD.EngineParallelism()
    assert TD.required_binary_parallelism(tw, tp) == \
        JD.required_binary_parallelism(jw, jp)
    assert TD.pipeline_schedule(tw, tp, sparsity) == \
        JD.pipeline_schedule(jw, jp, sparsity)
    assert TD.pipeline_efficiency(tw, tp, sparsity) == \
        JD.pipeline_efficiency(jw, jp, sparsity)
    assert TD.complexity_reduction(tw) == JD.complexity_reduction(jw)
    assert (tp.P_s, tp.P_b) == (jp.P_s, jp.P_b)


@pytest.mark.parametrize("timings", [
    (3.0, 1.5, 8), ([1.0, 2.0], [0.5, (0.25, 3.0)], 2),
    ([(1.0, 2.0, 0.5)] * 3, [2.0, 1.0, 4.0], 3)])
def test_measured_schedule_matches_jax(timings):
    ts, tb, heads = timings
    assert TD.measured_schedule(ts, tb, heads) == \
        JD.measured_schedule(ts, tb, heads)
    assert TD.measured_overlap_efficiency(ts, tb, heads) == \
        JD.measured_overlap_efficiency(ts, tb, heads)
    assert TD.schedule_metrics(ts, tb, heads) == \
        JD.schedule_metrics(ts, tb, heads)


@pytest.mark.parametrize("iters", [1, 4])
def test_layer_event_schedule_matches_jax(iters):
    rng = np.random.default_rng(3)
    macs = {ph: [float(v) for v in rng.integers(0, 100, 4) * 1.5]
            for ph in TD.LAYER_PHASE_NAMES}
    assert TD.layer_event_schedule(macs, 4, iters) == \
        JD.layer_event_schedule(macs, 4, iters)
    assert TD.LAYER_PHASE_NAMES == JD.LAYER_PHASE_NAMES == TFL.LAYER_PHASES


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("sparse", ["tile", "decoded"])
def test_layer_step_metrics_match_jax(sparse, pipeline):
    counts = _counts(8, 2, 5)
    kw = dict(seq=196, k_dim=512, head_dim=64, t_steps=4, batch=2,
              d_model=512, d_ff=2048, l_block=128, sparse=sparse,
              c_block=128, pipeline=pipeline)
    want = JD.fused_step_metrics(counts, **kw)
    assert TD.fused_step_metrics(counts, **kw) == want
    assert TD.fused_step_metrics(torch.from_numpy(counts), **kw) == want
    assert want["pipeline_iters"] == (4 if pipeline else 1)


def test_bundle_step_metrics_match_jax():
    counts = np.array([[3, 3, 2, 8], [4, 4, 4, 8], [0, 0, 0, 8]], np.int32)
    kw = dict(seq=64, k_dim=256, head_dim=32, t_steps=4, batch=1)
    assert TD.fused_step_metrics(counts, **kw) == \
        JD.fused_step_metrics(counts, **kw)
    assert TD.fused_step_metrics(counts.tolist(), **kw) == \
        JD.fused_step_metrics(counts.tolist(), **kw)


def test_metrics_of_a_pipelined_layer_call_match_jax():
    """The counts of one port pipelined layer call (the plain version):
    the same report from both modules; pipelining changes only the event
    model's iterations, and the pipelined hidden fraction is at least the
    fused one on these counts."""
    t, b, l, d, heads, hd, ff, l_block = 4, 2, 40, 32, 2, 16, 64, 16
    args = to_torch(layer_ops(9, t, b, l, d, heads, hd, ff))
    _, counts = TFL.fused_layer(*args, family="bn", num_heads=heads,
                                head_dim=hd, scale=1.0 / math.sqrt(hd),
                                l_block=l_block, pipeline=True)
    assert int(counts.sum()) > 0
    kw = dict(seq=l, k_dim=d, head_dim=hd, t_steps=t, batch=b, d_model=d,
              d_ff=ff, l_block=l_block)
    got = {p: TD.fused_step_metrics(counts, pipeline=p, **kw)
           for p in (False, True)}
    for p in (False, True):
        assert got[p] == JD.fused_step_metrics(counts.numpy(), pipeline=p,
                                               **kw)
    assert got[True]["executed_steps"] == got[False]["executed_steps"]
    assert got[True]["hidden_fraction"] >= got[False]["hidden_fraction"]
