"""Build and load the port's CUDA kernels.

The kernels in ``automix_tpu_torch/csrc`` are compiled at first use with
``nvcc`` into one shared library with a plain C interface, loaded with
``ctypes``.  The library is cached under ``build/kernels/`` at the root of
the checkout, named by a hash of the sources, so a changed source builds
anew.  Flags: ``sm_90a``, ``-O3``, ``-fmad=false`` and no fast math (see
``csrc/common.cuh`` for why parity needs both).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("fused_sweep.cu", "fused_stage1.cu")
_HEADERS = ("common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "am_fused_sweep": [_I, _I, _I, _I, ctypes.c_uint, _I, _I, _I]
    + [_P] * 4 + [_P] * 6 + [_P] * 6 + [_P] * 4 + [_P],
    "am_fused_stage1": [_I, _I, _I, _I, _I, ctypes.c_uint, _I, _I]
    + [_P] * 3 + [_P] * 4 + [_P] * 5 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless the cached library is current; returns
    the library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libautomix_kernels_{_source_hash()}.so"
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(_CSRC / s) for s in _SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(status: int, name: str):
    """Raise if a launcher reported a refused configuration or a CUDA
    error."""
    if status == -1:
        raise ValueError(f"{name}: shape not instantiated in the kernel")
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")
