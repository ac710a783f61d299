"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is compiled
with ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>.so`` at the root
of the checkout and loaded with ``ctypes``; a library newer than its sources
is reused. Nothing is built when a module is imported, and nothing but the
repository's own sources goes into a build. :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# name -> the C entry point's argument types (pointers and the stream are
# c_void_p so ctypes never cuts them to 32 bits)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "paged_decode_attention": [_P] * 8 + [_I] * 7 + [_P],
    "paged_prefill_attention": [_P] * 7 + [_I] * 8 + [_P],
    "autodma_tiled": [_P] * 3 + [ctypes.POINTER(_I), _I, ctypes.c_float, _P],
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}     # name -> nvcc's output (ptxas registers)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("repro_torch: nvcc not found; the CUDA kernels are "
                       "built on a machine with the CUDA toolkit")


def _sources(name: str) -> List[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(src.stat().st_mtime > built for src in _sources(name))


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"repro_torch: nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, _lib_path(name))


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> None:
    """Compile every stale kernel library, one ``nvcc`` each, in parallel."""
    with _LOCK:
        procs = {n: _start(n) for n in names if _stale(n)}
        for n, p in procs.items():
            _finish(n, p)


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            err = getattr(lib, name + "_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return _LIBS[name]


def check(name: str, code: int) -> None:
    """Raise unless the C entry point returned cudaSuccess."""
    if code != 0:
        msg = getattr(load(name), name + "_error")(code).decode()
        raise RuntimeError(f"repro_torch: {name} launch failed: "
                           f"cudaError {code} ({msg})")
