"""Meshes of ranks and the launcher that starts them.

JAX's meshes are single-controller: one process sees every device. The
port is SPMD over processes: one rank a mesh position, each holding its
slices of the params and cache (``parallel/sharding.shard_put``) and
running the model code on them, with the collectives of
``parallel/collectives.py`` over the mesh's axes.

* :class:`Mesh` — the axes ('data', 'model'), or ('pod', 'data',
  'model'), their sizes, this rank's coordinates, its device, the
  backend, a ``torch.distributed.device_mesh.DeviceMesh`` with the axis
  names, and one process group for every set of axes (the ranks that
  differ only along them). ``shape`` / ``axis_names`` / ``devices`` read
  as JAX's mesh's do, so the spec functions take either.
* :func:`make_serve_mesh`, :func:`make_host_mesh`,
  :func:`make_production_mesh` — the meshes of JAX's ``launch/mesh.py``,
  built inside the ranks from the running process group.
* :func:`launch` — starts ``data x model`` ranks (``torch.multiprocessing``
  spawn), initialises their group from a ``FileStore`` in a temporary
  directory, runs a function on every rank and returns rank 0's result;
  a rank that fails fails the launch.

The backend follows the devices (:func:`backend_for`): NCCL where every
rank has a GPU of its own; gloo where ranks share a device (the
one-card machine) or run on the CPU. Nothing falls back to the CPU
unless the caller names it."""
from __future__ import annotations

import itertools
import os
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


class Mesh:
    """An SPMD mesh over the running process group (see the module
    docstring). ``sizes``: {axis: size} in mesh order; the ranks lie
    row-major over it (rank = sum of coordinate x stride)."""

    def __init__(self, sizes: Dict[str, int], device: torch.device):
        n = int(np.prod(list(sizes.values())))
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n != world:
            raise ValueError(
                f"mesh {'x'.join(map(str, sizes.values()))} needs {n} ranks, "
                f"have {world} (start them with launch.mesh.launch)")
        self.axis_names: Tuple[str, ...] = tuple(sizes)
        self.shape: Dict[str, int] = dict(sizes)
        self.devices = np.arange(n).reshape(tuple(sizes.values()))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        coords = np.unravel_index(self.rank, self.devices.shape)
        self.coords = dict(zip(self.axis_names, (int(c) for c in coords)))
        self.device = device
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self._groups: Dict[Tuple[str, ...], Any] = {}
        self.device_mesh = None
        if dist.is_initialized():
            from torch.distributed.device_mesh import DeviceMesh
            # gloo ranks stage device tensors through the host: their
            # DeviceMesh is a CPU one whatever device the ranks compute on
            self.device_mesh = DeviceMesh(
                device.type if self.backend == "nccl" else "cpu",
                torch.arange(n).reshape(self.devices.shape),
                mesh_dim_names=self.axis_names)
            # every set of axes, in one order on every rank (new_group is
            # collective): single axes from the DeviceMesh, sets of
            # several through new_group
            for k in range(1, len(self.axis_names) + 1):
                for axes in itertools.combinations(self.axis_names, k):
                    self._groups[axes] = self._make_group(axes)

    def _make_group(self, axes: Tuple[str, ...]):
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if len(axes) == len(self.axis_names):
            return dist.group.WORLD
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(self.devices.ndim) if d not in dims]
        moved = np.moveaxis(self.devices, rest + dims,
                            list(range(self.devices.ndim)))
        mine = None
        for lead in np.ndindex(*moved.shape[:len(rest)]):
            ranks = [int(r) for r in moved[lead].reshape(-1)]
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def group(self, axes) -> Tuple[Any, int]:
        """(process group, size) of the ranks that differ only along
        ``axes`` (a name or several, those absent from the mesh ignored)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in self.axis_names if a in axes)
        n = int(np.prod([self.shape[a] for a in axes])) if axes else 1
        if n == 1:
            return None, 1
        return self._groups[axes], n

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend}, device={self.device})")


# the device of this process's rank, set by the launcher
_rank_device: Optional[torch.device] = None


def _device_of_rank() -> torch.device:
    return _rank_device if _rank_device is not None else resolve_device()


def make_serve_mesh(data: int = 1, model: int = 1, *,
                    device: Optional[torch.device] = None) -> Mesh:
    """Serving mesh: request slots on 'data', attention heads / d_ff /
    vocab on 'model'; needs ``data * model`` running ranks."""
    return Mesh({"data": data, "model": model},
                device if device is not None else _device_of_rank())


def make_host_mesh(*, device: Optional[torch.device] = None) -> Mesh:
    """Every running rank as a 1-D 'data' mesh."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh({"data": n},
                device if device is not None else _device_of_rank())


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[torch.device] = None) -> Mesh:
    """Single-pod (data=16, model=16): 256 ranks; multi-pod (pod=2,
    data=16, model=16): 512 ranks. Raises on a smaller world."""
    sizes = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    return Mesh(sizes, device if device is not None else _device_of_rank())


def backend_for(n_ranks: int, device: torch.device) -> str:
    """NCCL where every rank has a GPU of its own, else gloo (ranks that
    share a device, or the CPU)."""
    if device.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank: int, fn: Callable, args: tuple, kwargs: dict,
               sizes: Dict[str, int], store_dir: str, backend: str,
               device: str, threads: Optional[int]):
    if threads is not None:
        torch.set_num_threads(threads)
    n = int(np.prod(list(sizes.values())))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    global _rank_device
    _rank_device = dev
    store = dist.FileStore(os.path.join(store_dir, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    try:
        mesh = Mesh(sizes, dev)
        out = fn(mesh, *args, **kwargs)
        if rank == 0:
            torch.save(out, os.path.join(store_dir, "result.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, data: int = 1, model: int = 1, *args,
           device: DeviceLike = None, store_dir: Optional[str] = None,
           threads: Optional[int] = None, **kwargs) -> Any:
    """Run ``fn(mesh, *args, **kwargs)`` on ``data x model`` ranks and
    return rank 0's result (``fn`` may build another mesh over the same
    ranks, e.g. one with a 'pod' axis). ``fn`` must be importable (a module-level function); its result is
    passed back through ``torch.save``. ``device``: the ranks' device,
    the GPU by default. ``store_dir``: where the ``FileStore`` lives (a
    new temporary directory by default). ``threads``: each rank's
    intra-op threads."""
    import torch.multiprocessing as mp
    dev = resolve_device(device)
    sizes = {"data": data, "model": model}
    n = data * model
    backend = backend_for(n, dev)
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        mp.start_processes(_rank_main, nprocs=n, join=True,
                           start_method="spawn",
                           args=(fn, args, kwargs, sizes, tmp, backend,
                                 dev.type, threads))
        return torch.load(os.path.join(tmp, "result.pt"),
                          weights_only=False)


def parse_mesh(text: str) -> Tuple[int, int]:
    """'DATAxMODEL' -> (data, model)."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {text!r}: expected DATAxMODEL, e.g. 2x2"
                         ) from None
    if d < 1 or m < 1:
        raise ValueError(f"mesh {text!r}: sizes must be >= 1")
    return d, m
