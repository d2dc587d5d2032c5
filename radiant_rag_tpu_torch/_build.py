"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` is compiled by its own `nvcc` process (all started
together) into a shared library with a plain C interface under
`build/kernels/` at the root of the checkout; the file name carries a hash
of the source and the headers, so an edited kernel is rebuilt and an
unchanged one is loaded as is. A build failure raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr per source (ptxas register / shared-memory report)
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every kernel source not yet built; returns the seconds spent."""
    with _lock:
        t0 = time.perf_counter()
        todo = [(src, _target(src)) for src in sorted(CSRC.glob("*.cu"))]
        todo = [(src, so) for src, so in todo if not so.is_file()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = []
        for src, so in todo:
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, so, tmp, proc in procs:
            out, err = proc.communicate()
            build_log[src.stem] = (out + err).strip()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{err.strip()}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        return time.perf_counter() - t0


def library_path(stem: str) -> Path:
    """Where the shared library of `csrc/<stem>.cu` is built."""
    return _target(CSRC / f"{stem}.cu")


def library(stem: str) -> ctypes.CDLL:
    """The loaded shared library of `csrc/<stem>.cu`, built on first use."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    so = library_path(stem)
    if not so.is_file():
        build_all()
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(so))
            _libs[stem] = lib
    return lib
