"""Checkpoints in the JAX package's on-disk format, with async saves.

Port of ``repro.checkpoint.manager``. One directory per step holds

  manifest.json  — the path-keyed leaves (file, shape, dtype, bytes), the
                   kind of every container (dict / list / tuple, empty
                   ones too), the step and the caller's ``extra``;
  leafNNNNN.npy  — one file per leaf, in the leaf's own dtype.

So a checkpoint either package writes, the other restores, bit for bit:
fp32, int8 weight codes, packed-int4 uint8 nibbles, int32 leaves. Three
dtypes need care, and are handled without ``ml_dtypes``:

* bfloat16 (and the fp8 types) are written as their raw bits (uint16 /
  uint8) with the logical dtype in the manifest, as JAX writes them, and
  read back through a same-width integer view into the torch dtype;
* the packed KV cache's uint32 words of a JAX checkpoint restore as
  int32 tensors with the same bits, the port's word type
  (``core/bitpack``); a leaf the port writes as int32 stays int32 on
  disk, which JAX restores as int32.

Restore works against a template tree or without one (the manifest's
container kinds rebuild the nesting), and puts the leaves on the
``device`` it is given (the GPU by default), where JAX places them
against shardings.

As in JAX: a save writes ``<dir>.tmp`` and renames it into place with
``os.replace``, so a crash mid-save never corrupts the latest
checkpoint; :class:`CheckpointManager` copies the tree to the host before
its writer thread starts and blocks only on the previous save (double
buffering), and keeps the last ``keep_last`` steps plus every
``durable_every``-th.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import _leaf_to_torch

# logical dtype -> (torch dtype, numpy payload on disk, and the
# same-width integer type through which torch and numpy view the bits)
_EXTENDED_DTYPES = {
    "bfloat16": (torch.bfloat16, np.uint16, torch.int16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8, np.uint8)}
_TORCH_EXTENDED = {v[0]: k for k, v in _EXTENDED_DTYPES.items()}


def _flatten_with_paths(tree) -> Dict[str, Any]:
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (str(k),), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(path + (str(i),), v)
        else:
            flat["/".join(path)] = node
    walk((), tree)
    return flat


def _container_kinds(tree) -> Dict[str, str]:
    """Internal-node kinds by path ('' = root): every container is
    recorded, empty ones too (no leaf implies them), so the tree
    rebuilds with no template."""
    kinds: Dict[str, str] = {}

    def walk(path, node):
        key = "/".join(path)
        if isinstance(node, dict):
            kinds[key] = "dict"
            for k, v in node.items():
                walk(path + (str(k),), v)
        elif isinstance(node, (list, tuple)):
            kinds[key] = "tuple" if isinstance(node, tuple) else "list"
            for i, v in enumerate(node):
                walk(path + (str(i),), v)
    walk((), tree)
    return kinds


def _unflatten_from_manifest(flat: Dict[str, Any], kinds: Dict[str, str]):
    """Template-free rebuild: seed every recorded container (so empty
    lists / dicts survive), nest the leaves by their '/'-split paths,
    then turn list / tuple nodes (children keyed '0'..'n-1') back into
    sequences."""
    root: Dict[str, Any] = {}

    def ensure(parts):
        node = root
        for p in parts:
            node = node.setdefault(p, {})
        return node

    for path in kinds:
        if path:
            ensure(path.split("/"))
    for path, leaf in flat.items():
        parts = path.split("/")
        ensure(parts[:-1])[parts[-1]] = leaf

    def rebuild(path: str, node):
        if not isinstance(node, dict):
            return node
        built = {k: rebuild(f"{path}/{k}" if path else k, v)
                 for k, v in node.items()}
        kind = kinds.get(path)
        if kind in ("list", "tuple"):
            seq = [built[str(i)] for i in range(len(built))]
            return tuple(seq) if kind == "tuple" else seq
        return built
    return rebuild("", root)


def _unflatten(template, flat: Dict[str, Any]):
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (str(k),), v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(path + (str(i),), v) for i, v in enumerate(node)]
        if isinstance(node, tuple):
            return tuple(walk(path + (str(i),), v)
                         for i, v in enumerate(node))
        return flat["/".join(path)]
    return walk((), template)


def _host_leaf(leaf) -> Tuple[np.ndarray, str]:
    """(an owned numpy copy of the payload written to disk, the logical
    dtype's name) of a tensor or any array ``numpy.asarray`` takes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _TORCH_EXTENDED:
            name = _TORCH_EXTENDED[t.dtype]
            _, disk, bits, _ = _EXTENDED_DTYPES[name]
            return t.view(bits).numpy().view(disk).copy(), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name in _EXTENDED_DTYPES:
        arr = arr.view(_EXTENDED_DTYPES[name][1])
    return np.array(arr, copy=True), name


def _write(host: Dict[str, Tuple[np.ndarray, str]], kinds: Dict[str, str],
           directory: str, step: int, extra: Optional[dict]) -> None:
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {},
                "containers": kinds}
    for i, (path, (arr, dtype_name)) in enumerate(sorted(host.items())):
        fname = f"leaf{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][path] = {"file": fname,
                                    "shape": list(arr.shape),
                                    "dtype": dtype_name,
                                    "nbytes": int(arr.nbytes)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)


def _host_copy(tree):
    return ({p: _host_leaf(l) for p, l in _flatten_with_paths(tree).items()},
            _container_kinds(tree))


def save_tree(tree, directory: str, step: int,
              extra: Optional[dict] = None) -> None:
    """Write ``tree`` (tensors, or numpy / JAX arrays) as the checkpoint
    ``directory`` of ``step``, atomically."""
    _write(*_host_copy(tree), directory, step, extra)


def _leaf_from_disk(arr: np.ndarray, dtype_name: str,
                    dev: torch.device) -> torch.Tensor:
    if dtype_name in _EXTENDED_DTYPES:
        dt, _, _, bits = _EXTENDED_DTYPES[dtype_name]
        return torch.from_numpy(arr.view(bits)).view(dt).to(dev)
    return _leaf_to_torch(arr, dev)     # uint32 words -> int32, same bits


def restore_tree(directory: str, template=None, *,
                 device: DeviceLike = None):
    """-> (tree of tensors on ``device``, step, extra). With a template
    tree the leaves take its structure; with ``template=None`` the
    manifest's container kinds rebuild it."""
    dev = resolve_device(device)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {path: _leaf_from_disk(
                np.load(os.path.join(directory, info["file"])),
                info["dtype"], dev)
            for path, info in manifest["leaves"].items()}
    if template is None:
        if "containers" not in manifest:
            raise ValueError(
                f"checkpoint {directory} predates container-kind "
                f"manifests: template-free restore cannot distinguish "
                f"lists from dicts; pass a template tree")
        tree = _unflatten_from_manifest(flat, manifest["containers"])
    else:
        tree = _unflatten(template, flat)
    return tree, manifest["step"], manifest.get("extra", {})


def dir_nbytes(directory: str) -> int:
    """On-disk payload bytes of a checkpoint (the leaf files only)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    return sum(os.path.getsize(os.path.join(directory, info["file"]))
               for info in manifest["leaves"].values())


class CheckpointManager:
    """Async double-buffered checkpoint manager with a retention policy:
    one ``step_NNNNNNNN`` directory a saved step under ``root``."""

    def __init__(self, root: str, keep_last: int = 3,
                 durable_every: int = 0):
        self.root = root
        self.keep_last = keep_last
        self.durable_every = durable_every
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def steps(self):
        out = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, extra: Optional[dict] = None,
             blocking: bool = False):
        """Save ``tree`` as ``step``: the host copy is taken now, the
        write runs on a thread unless ``blocking``; waits for the
        previous save first."""
        self.wait()
        host = _host_copy(tree)

        def work():
            _write(*host, self._step_dir(step), step, extra)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def restore(self, template=None, step: Optional[int] = None, *,
                device: DeviceLike = None):
        """The latest checkpoint (or ``step``) as :func:`restore_tree`
        returns it, or None when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return restore_tree(self._step_dir(step), template, device=device)

    def _gc(self):
        steps = self.steps()
        keep = set(steps[-self.keep_last:])
        if self.durable_every:
            keep |= {s for s in steps if s % self.durable_every == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
