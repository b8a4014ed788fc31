"""The port's checkpoints (``checkpoint/manager``) against the JAX
package's (``repro.checkpoint``): one on-disk format both ways.

* a tree JAX saves restores in the port, with a template and without
  one, bitwise: fp32, bf16 (uint16 bits on disk), int8 ``qw`` codes,
  packed int4 uint8 nibbles, int32, and uint32 KV words, which come back
  as int32 tensors with the same bits; lists, tuples and empty
  containers keep their kind;
* a tree the port saves restores in JAX, bitwise, its int32 words as
  int32;
* the manifests' leaves and ``dir_nbytes`` equal JAX's for the same tree;
* ``CheckpointManager``: the steps kept by ``keep_last`` /
  ``durable_every`` equal JAX's, a stale ``.tmp`` directory is replaced,
  and an async save writes the tree as it was when ``save`` returned.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as JC  # noqa: E402
from repro.checkpoint import manager as JM  # noqa: E402
from repro_torch import checkpoint as TC  # noqa: E402
from repro_torch import interop  # noqa: E402


def _tree():
    """numpy leaves of every dtype a param or cache tree holds."""
    rng = np.random.default_rng(4)
    return {
        "params": {
            "w": rng.normal(size=(3, 4)).astype(np.float32),
            "emb": rng.normal(size=(5, 2)).astype(ml_dtypes.bfloat16),
            "wo": {"qw": rng.integers(-127, 128, (4, 3), dtype=np.int8),
                   "scale": rng.random(3).astype(np.float32)},
            "up": {"qw": rng.integers(0, 256, (2, 3), dtype=np.uint8),
                   "scale": rng.random(3).astype(np.float32)},
            "delta": np.float32(0.3)},
        "cache": {"k": rng.integers(0, 2 ** 32, (2, 3), dtype=np.uint32),
                  "pos": rng.integers(-5, 5, (2,), dtype=np.int32)},
        "hist": [np.arange(3, dtype=np.float32), ()],
        "pair": (np.int32(7), {}),
        "none": [],
    }


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(
        {2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_same_bits(want, got):
    """numpy tree ``want`` against ``got`` (tensors or numpy): the same
    structure, equal bits; uint32 held by int32 tensors."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_same_bits(want[k], got[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for w, g in zip(want, got):
            _assert_same_bits(w, g)
    else:
        want = np.asarray(want)
        if isinstance(got, torch.Tensor):
            tdt = interop.to_torch(want, device="cpu").dtype
            assert got.dtype == tdt and tuple(got.shape) == want.shape
            got = interop.to_numpy(got)
        assert np.asarray(got).shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("template", [False, True])
def test_jax_checkpoint_restores_in_the_port(tmp_path, template):
    tree = _tree()
    d = str(tmp_path / "step_00000003")
    JC.save_tree(tree, d, 3, extra={"quant": "int8"})
    tmpl = interop.to_torch(tree, device="cpu") if template else None
    got, step, extra = TC.restore_tree(d, tmpl, device="cpu")
    assert step == 3 and extra == {"quant": "int8"}
    _assert_same_bits(tree, got)
    assert got["cache"]["k"].dtype == torch.int32


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = interop.to_torch(_tree(), device="cpu")
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    TC.save_tree(tree, td, 5)
    got, step, _ = JC.restore_tree(td)
    assert step == 5
    want = interop.to_numpy(tree)
    _assert_same_bits(want, got)
    assert np.asarray(got["cache"]["k"]).dtype == np.int32
    assert np.asarray(got["params"]["emb"]).dtype == ml_dtypes.bfloat16
    # the same tree through JAX: the same manifest, the same payload
    JC.save_tree(want, jd, 5)
    assert _manifest(jd) == _manifest(td)
    assert TC.dir_nbytes(td) == JM.dir_nbytes(jd) > 0
    _assert_same_bits(want, TC.restore_tree(jd, device="cpu")[0])


def test_manager_retention_tmp_and_async_copy(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3, dtype=torch.bfloat16)}
    jm = JC.CheckpointManager(str(tmp_path / "jax"), keep_last=2,
                              durable_every=4)
    tm = TC.CheckpointManager(str(tmp_path / "port"), keep_last=2,
                              durable_every=4)
    stale = os.path.join(tm.root, "step_00000006.tmp")
    os.makedirs(stale)
    open(os.path.join(stale, "junk"), "w").close()
    for step in (2, 4, 6, 8, 10):
        jm.save(step, interop.to_numpy(tree))
        tm.save(step, tree)
        if step == 8:
            # the host copy is taken before save returns: an in-place
            # change after it does not reach step 8's files
            tree["w"].add_(100.0)
    jm.wait()
    tm.wait()
    assert tm.steps() == jm.steps() == [4, 8, 10]
    assert sorted(os.listdir(tm.root)) == sorted(os.listdir(jm.root))
    assert tm.latest_step() == 10
    got8, step, _ = tm.restore(step=8, device="cpu")
    assert step == 8
    assert torch.equal(got8["w"], torch.arange(6.0).reshape(2, 3))
    got, step, _ = tm.restore(device="cpu")
    assert step == 10 and torch.equal(got["w"], tree["w"])
    assert got["b"].dtype == torch.bfloat16
    assert TC.CheckpointManager(str(tmp_path / "empty")).restore() is None
