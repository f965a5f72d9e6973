"""Build and load the port's CUDA kernels.

The kernels in ``automix_tpu_torch/csrc`` are compiled at first use with
``nvcc`` into one shared library with a plain C interface, loaded with
``ctypes``.  Each compilation unit (a source, and for the stage-3 sweep
kernel two units per perm / Student-t variant, one of them K1d's, for the
stage-1 kernels one per Student-t variant) is compiled by its own
``nvcc`` process, as many at once as there are CPU cores, then linked.
The (K, D) shapes the kernels are instantiated for are :data:`SHAPES`,
written for the compiler into a generated ``am_shapes.h`` (the
``AM_SHAPES`` X-macro that ``csrc/common.cuh`` includes); the rb9 family's
data are written into a generated ``am_rb9.h`` from ``models/rb9.py``,
the DDI family's tables into ``am_ddi.h`` from ``models/ddi_cols.py`` and
the change-point events into ``am_cpt.h`` from ``models/changepoint.py``.  The library is
cached under ``build/kernels/`` at the root of the checkout, named by a
hash of the sources and flags, so a changed source builds anew; the
compilers' output (``ptxas -v`` register and spill counts) is kept beside
it in a ``.log`` file, with the seconds each unit took.  Flags:
``sm_90a``, ``-O3``, ``-fmad=false`` and no fast math (see
``csrc/common.cuh`` for why parity needs both).
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

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_HEADERS = ("common.cuh", "ddi.cuh", "changepoint.cuh",
            "fused_sweep_body.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

# The (K, D) model-set shapes every kernel is instantiated for.
SHAPES = ((1, 1), (1, 2), (2, 2), (3, 2), (5, 5), (10, 5), (2, 16),
          (6, 13))
# The DDI family's shape (am_ddi.h's AM_DDI_K, AM_DDI_D): there the stage-3
# sweep kernel has its cached form (K1e) only, every other shape its
# stateless form only.
CACHED_SHAPE = (2, 16)


def shapes_header() -> str:
    """The generated ``am_shapes.h``: :data:`SHAPES` as the X-macro the
    launchers expand into one case per instantiation."""
    cases = " ".join(f"X({k}, {d})" for k, d in SHAPES)
    return ("// Generated by automix_tpu_torch/kernels/_build.py from SHAPES.\n"
            f"#define AM_SHAPES(X) {cases}\n")


def generated_headers() -> dict:
    """The generated headers by file name: ``am_shapes.h``, ``am_rb9.h``,
    ``am_ddi.h`` and ``am_cpt.h``."""
    from automix_tpu_torch.models import changepoint, ddi, rb9
    return {"am_shapes.h": shapes_header(), "am_rb9.h": rb9.header(),
            "am_ddi.h": ddi.header(), "am_cpt.h": changepoint.header()}


def sweep_symbol(perm: bool, tdist: bool, kind: str = "") -> str:
    """Exported name of a stage-3 sweep function of one variant: the
    per-chain launcher (``kind=""``), the pooled launcher (``"pooled"``),
    the pooled capacity query (``"pooled_cap"``), the largest-L query
    (``"max_l"``), the per-chain kernel's occupancy query
    (``"occupancy"``), K1d's launcher (``"scan"``) or its grid query
    (``"scan_grid"``)."""
    infix = f"_{kind}" if kind else ""
    return f"am_fused_sweep{infix}_p{int(perm)}_t{int(tdist)}"


def stage1_sweep_symbol(tdist: bool, kind: str = "") -> str:
    """Exported name of a stage-1 one-sweep function (K3) of one unit,
    Normal or Student-t: the launcher (``kind=""``) or its grid query
    (``"grid"``)."""
    infix = f"_{kind}" if kind else ""
    return f"am_fused_stage1_sweep{infix}_t{int(tdist)}"


def stage1_symbol(tdist: bool, kind: str = "") -> str:
    """Exported name of a stage-1 segment function of one unit (Normal or
    Student-t): the launcher (``kind=""``) or the capacity query
    (``"cap"``)."""
    infix = f"_{kind}" if kind else ""
    return f"am_fused_stage1{infix}_t{int(tdist)}"


# (source, preprocessor definitions) of each compilation unit, longest
# first: at most one unit a CPU core compiles at once (build), started in
# this order, so the short units take the cores the long ones leave.
_UNITS = tuple(
    ("fused_sweep.cu", (f"-DAM_PERM={p}", f"-DAM_TDIST={t}",
                        f"-DAM_K1_SYMBOL={sweep_symbol(p, t)}",
                        f"-DAM_K1C_SYMBOL={sweep_symbol(p, t, 'pooled')}",
                        "-DAM_K1C_CAP_SYMBOL="
                        f"{sweep_symbol(p, t, 'pooled_cap')}",
                        f"-DAM_K1_MAXL_SYMBOL={sweep_symbol(p, t, 'max_l')}",
                        "-DAM_K1_OCC_SYMBOL="
                        f"{sweep_symbol(p, t, 'occupancy')}"))
    for p in (0, 1) for t in (0, 1)) + tuple(
    ("fused_stage1_sweep.cu", (
        f"-DAM_K3_T={t}", f"-DAM_K3_SYMBOL={stage1_sweep_symbol(t)}",
        f"-DAM_K3_GRID_SYMBOL={stage1_sweep_symbol(t, 'grid')}"))
    for t in (0, 1)) + tuple(
    ("fused_sweep.cu", (f"-DAM_PERM={p}", f"-DAM_TDIST={t}", "-DAM_SCAN=1",
                        f"-DAM_K1D_SYMBOL={sweep_symbol(p, t, 'scan')}",
                        "-DAM_K1D_GRID_SYMBOL="
                        f"{sweep_symbol(p, t, 'scan_grid')}"))
    for p in (0, 1) for t in (0, 1)) + tuple(
    ("fused_stage1.cu", (f"-DAM_STAGE1_T={t}",
                         f"-DAM_STAGE1_SYMBOL={stage1_symbol(t)}",
                         f"-DAM_STAGE1_CAP_SYMBOL={stage1_symbol(t, 'cap')}"))
    for t in (0, 1)) + (
    ("sweep_rng.cu", ()),
)

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    **{sweep_symbol(p, t): [_I, _I, _I, _I, _U, _I, _I, _I, _I, _I, _P]
       + [_P] * 4 + [_P] * 6 + [_P] * 6 + [_P] * 4 + [_P]
       for p in (0, 1) for t in (0, 1)},
    **{sweep_symbol(p, t, "pooled"): [_I, _I, _I, _I, _U, _I, _I, _I, _P]
       + [_P, _F] + [_P] * 4 + [_P] * 6 + [_P] * 6 + [_P] * 4 + [_P]
       for p in (0, 1) for t in (0, 1)},
    **{sweep_symbol(p, t, kind): [_I, _I, _I, _P]
       for p in (0, 1) for t in (0, 1)
       for kind in ("pooled_cap", "max_l", "occupancy")},
    **{sweep_symbol(p, t, "scan"): [_I, _I, _I, _I, _U, _I, _I, _I, _P, _I]
       + [_P, _F] + [_P] * 4 + [_P] * 3 + [_P] * 6 + [_P] * 4 + [_P]
       for p in (0, 1) for t in (0, 1)},
    **{sweep_symbol(p, t, "scan_grid"): [_I, _I, _I, _I, _P]
       for p in (0, 1) for t in (0, 1)},
    **{stage1_symbol(t): [_I, _I, _I, _I, _I, _U, _I, _I, _P, _I, _F]
       + [_P] + [_P] * 3 + [_P] * 4 + [_P] * 5 + [_P] for t in (0, 1)},
    **{stage1_symbol(t, "cap"): [_I, _I, _P] for t in (0, 1)},
    **{stage1_sweep_symbol(t): [_I, _I, _I, _I, _I, _I, _I, _U, _I, _I,
                                _P, _I, _F] + [_P] * 3 + [_P] * 2 + [_P] * 3
       + [_P] * 3 + [_P] for t in (0, 1)},
    **{stage1_sweep_symbol(t, "grid"): [_I, _P, _P] for t in (0, 1)},
    "am_sweep_rng": [_I, _I, _I, _I, _U, _U, _I, _P, _P, _P],
}


def tconsts(tdist):
    """The Student-t constants (``randoms.StudentT``) as the host float
    array the launchers read, or None (a null pointer) for Normal draws."""
    return None if tdist is None else (ctypes.c_float * 5)(*tdist)


def check_shape(K: int, D: int, name: str):
    """Raise for a (K, D) pair the kernels are not instantiated for."""
    if (K, D) not in SHAPES:
        raise ValueError(
            f"{name}: no kernel instantiation for K={K}, D={D}; the "
            f"kernels are instantiated for (K, D) in {list(SHAPES)}")


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
    for name in sorted({u[0] for u in _UNITS}) + list(_HEADERS):
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(repr((NVCC_FLAGS, _UNITS)).encode())
    for name, text in sorted(generated_headers().items()):
        h.update(name.encode())
        h.update(text.encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless the cached library is current; returns
    the library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libautomix_kernels_{_source_hash()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    work.mkdir(exist_ok=True)
    for name, text in generated_headers().items():
        (work / name).write_text(text)
    t0 = time.time()
    cmds = [[nvcc, *NVCC_FLAGS, *defines, f"-I{work}", "-c", "-o",
             str(work / f"{i}_{Path(src).stem}.o"), str(_CSRC / src)]
            for i, (src, defines) in enumerate(_UNITS)]
    procs, started = [], []
    cores = max(1, len(os.sched_getaffinity(0)))
    try:
        # one unit a core at once, started in _UNITS order
        while len(procs) < len(cmds) or any(
                p.poll() is None for p in procs):
            for i, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise RuntimeError(
                        f"nvcc failed ({p.returncode}):\n"
                        f"{' '.join(cmds[i])}\n{_output(work, i)}")
            while len(procs) < len(cmds) and sum(
                    p.poll() is None for p in procs) < cores:
                i = len(procs)
                with open(work / f"{i}.out", "w") as fh:
                    procs.append(subprocess.Popen(
                        cmds[i], stdout=fh, stderr=subprocess.STDOUT))
                started.append(time.time() - t0)
            time.sleep(0.1)
        log = []
        for i, cmd in enumerate(cmds):
            secs = Path(cmd[-2]).stat().st_mtime - t0
            log.append(f"$ {' '.join(cmd)}\n{_output(work, i)}unit started "
                       f"after {started[i]:.1f} s, unit done after "
                       f"{secs:.1f} s\n")
        lib_tmp = work / out.name
        cmd = [nvcc, "-shared", "-o", str(lib_tmp),
               *[c[-2] for c in cmds]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(lib_tmp, out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    return out


def _output(work: Path, i: int) -> str:
    """What unit i's compiler printed."""
    return (work / f"{i}.out").read_text()


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
        raise ValueError(f"{name}: shape or L not instantiated in the "
                         "kernel")
    if status == -2:
        raise ValueError(f"{name}: more chains than the card holds resident "
                         "for a cooperative launch")
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")
