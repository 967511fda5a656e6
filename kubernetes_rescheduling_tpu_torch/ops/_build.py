"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``. Builds happen at first use — never at import — into
``ops/build/`` (listed in ``.gitignore``), under a name that carries a
hash of the sources and flags, so an edited kernel is never served from a
stale build. :func:`build` compiles several sources at once, one ``nvcc``
process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
SOURCES = ("mass", "score", "admission", "sparse_mass", "mass_score", "swap", "pod_cost")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the exported launch functions (see each source)
_ARGTYPES = {
    "krt_mass_launch": [_I, _P, _I, _P, _P, _P] + [_I] * 6 + [_P, _P],
    "krt_score_launch": [_I] + [_P] * 12 + [_F] * 2 + [_P] * 2 + [_I] * 10 + [_P] * 6,
    "krt_admission_launch": (
        [_I] + [_P] * 9 + [_I] * 3 + [_P] * 5 + [_I] * 3 + [_P, _L] + [_P] * 5 + [_P]
    ),
    "krt_sparse_mass_launch": [_I, _P, _I, _L] + [_P] * 4 + [_I] * 7 + [_P, _P],
    "krt_hub_mass_launch": [_I, _P, _I, _L] + [_P] * 6 + [_I] * 6 + [_P, _P],
    "krt_mass_score_launch": (
        [_I, _P, _I, _L] + [_P] * 5 + [_I] * 7 + [_P] * 11 + [_F] * 2 + [_P] * 2 + [_I] * 4
        + [_P] * 5 + [_P, _I, _P]
    ),
    "krt_swap_desire_launch": [_I] + [_P] * 8 + [_I] * 4 + [_P] * 2,
    "krt_swap_decide_launch": (
        [_I, _P, _I, _P, _P, _I, _L] + [_P] * 12 + [_F] * 2 + [_P] * 2 + [_I] * 3 + [_P] * 6
    ),
    "krt_pod_cross_launch": [_I] + [_P] * 5 + [_L, _L, _P, _P],
    "krt_error_string": [_I],
}
_RESTYPES = {"krt_error_string": ctypes.c_char_p}

_LIBS: dict[str, ctypes.CDLL] = {}
_build_s = 0.0  # seconds build() has spent compiling in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict[str, str]:
    """Compile every named source that has no current build, in parallel.

    Returns ``{name: compiler output}`` for the sources compiled now (with
    ``verbose``, ``-Xptxas -v`` adds each kernel's registers, shared memory
    and spills). Raises with the compiler's output if any build fails."""
    global _build_s
    extra = ("-Xptxas", "-v") if verbose else ()
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, target in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (tmp, target, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            os.unlink(tmp)
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{out}")
    _build_s += time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def build_seconds() -> float:
    """Seconds :func:`build` has spent compiling in this process."""
    return _build_s


def load(path) -> ctypes.CDLL:
    """A built kernel library, its launch functions given their C signatures."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _ARGTYPES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name] = load(_target(name))
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned anything but cudaSuccess."""
    if code != 0:
        msg = lib.krt_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
