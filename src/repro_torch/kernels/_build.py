"""Builds the port's CUDA sources (``kernels/csrc/*.cu``) at first use.

Each source becomes a shared library with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the root of the
checkout and loaded with ``ctypes``. The library name carries a hash of
the source, the headers beside it (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
:func:`build` starts one ``nvcc`` per missing source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("fused_layer", "spike_matmul", "spike_attention",
           "gather_spike_matmul", "popcount_attention", "lif")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> (build seconds, compiler output) for sources built in this process
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library lives: its name carries a hash of
    the source, of every header in ``csrc/`` (a source may include any
    of them) and of the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source that has no library yet, in parallel."""
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists() or name in procs:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = (time.perf_counter() - t0, log)
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing."""
    if name not in _LIBS:
        build((name,))
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
