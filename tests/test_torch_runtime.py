"""The port's supervised training loop (``launch/train.py`` with
``runtime/fault_tolerance.py`` and ``checkpoint/``) on the CPU.

* the numpy-only fault-tolerance copy against
  ``repro.runtime.fault_tolerance``: the injector's failures for one seed
  and rate, the straggler monitor's flags and EWMA, the supervisor's
  restarts and its exhausted budget;
* ``train('spikingformer-lm', smoke=True)`` lowers the loss;
* a run that fails at a step and restarts from its checkpoint (through
  the command line, with QAT and compressed gradients) replays the steps
  after the checkpoint with the same losses and ends with a checkpoint
  bitwise equal to an uninterrupted run's: the data stream, the step
  and the optimizer state (with the compression residuals) all resume
  exactly;
* compressed gradients end within the margin of JAX's
  ``tests/test_runtime.py`` (0.25 on the mean of the last five losses) of
  the uncompressed run.
"""
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.runtime import fault_tolerance as JF  # noqa: E402
from repro_torch.checkpoint import restore_tree  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.runtime import fault_tolerance as TF  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "spikingformer-lm"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_failure_injector_matches_jax():
    runs = []
    for mod in (JF, TF):
        inj = mod.FailureInjector(rate=0.2, seed=3, failure_steps=[5])
        fails = []
        for step in list(range(40)) + [5, 6]:
            try:
                inj.maybe_fail(step)
            except mod.SimulatedFailure as e:
                fails.append((step, str(e)))
        runs.append((fails, inj.injected))
    assert runs[0] == runs[1] and len(runs[0][0]) > 2
    assert issubclass(TF.SimulatedFailure, RuntimeError)


def test_straggler_monitor_matches_jax():
    times = [0.1, 0.11, 0.09, 0.5, 0.1, 0.12, 0.3, 0.1, 0.25, 0.1]
    out = []
    for mod in (JF, TF):
        seen = []
        mon = mod.StragglerMonitor(threshold=2.0, alpha=0.1,
                                   on_straggler=lambda r: seen.append(r.step))
        recs = [mon.observe(i, s) for i, s in enumerate(times)]
        out.append(([(r.step, r.seconds, r.flagged) for r in recs],
                    mon.straggler_steps, seen, mon.ewma))
    assert out[0] == out[1] and out[1][1] == [3, 6, 8] == out[1][2]


@pytest.mark.parametrize("fail_times", [2, 4])
def test_supervisor_matches_jax(fail_times):
    out = []
    for mod in (JF, TF):
        left = [fail_times]

        def segment(start):
            if left[0]:
                left[0] -= 1
                raise mod.SimulatedFailure(f"fail {left[0]}")
            return 10
        sup = mod.TrainSupervisor(max_restarts=3)
        try:
            res = sup.run(segment, 0, 10)
        except RuntimeError as e:
            res = str(e)
        out.append((res, [(r["at_step"], r["error"]) for r in sup.restarts]))
    assert out[0] == out[1]
    assert (out[1][0] == 10) == (fail_times <= 3)


def _smoke(**kw):
    return TT.train(ARCH, True, kw.pop("steps", 14), 8, 3e-3, seed=0,
                    device="cpu", seq=kw.pop("seq", 32), **kw)


def test_lm_training_lowers_the_loss():
    losses = _smoke(steps=30, seq=64)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_resumed_run_equals_an_uninterrupted_one(tmp_path, monkeypatch,
                                                 capsys):
    kw = dict(qat="int8", compress=True, ckpt_every=5)
    base = _smoke(ckpt_dir=str(tmp_path / "base"), **kw)
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--smoke", "--steps", "14", "--batch", "8",
        "--seq", "32", "--lr", "3e-3", "--device", "cpu", "--qat", "int8",
        "--compress-grads", "--ckpt-dir", str(tmp_path / "failed"),
        "--ckpt-every", "5", "--inject-failure-at", "7"])
    TT.main()
    out = capsys.readouterr().out
    assert "restored checkpoint @ step 5" in out
    assert "survived 1 restart(s)" in out
    got, step, _ = restore_tree(str(tmp_path / "failed" / "step_00000014"),
                                device="cpu")
    want, wstep, _ = restore_tree(str(tmp_path / "base" / "step_00000014"),
                                  device="cpu")
    assert step == wstep == 14
    assert sorted(got) == ["opt", "params"] and "compress_err" in got["opt"]
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    # the same run in-process: steps 0-6, then 5-13 replayed from the
    # checkpoint of step 5 with the same losses
    rerun = _smoke(ckpt_dir=str(tmp_path / "rerun"), inject_failure_at=7,
                   **kw)
    assert rerun == base[:7] + base[5:]


def test_compressed_run_is_close_to_the_uncompressed_one():
    kw = dict(steps=25, seq=64)
    base, comp = _smoke(**kw), _smoke(compress=True, **kw)
    assert base != comp
    assert abs(np.mean(base[-5:]) - np.mean(comp[-5:])) < 0.25
