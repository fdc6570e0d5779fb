"""Build and load the CUDA kernels of `csrc/`.

`nvcc` compiles `csrc/*.cu` into a shared library with a plain C interface,
at the first call, into `build/paml_tpu_torch/` beside the package; the
file name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  The library is loaded
with `ctypes`: every pointer and the stream are passed as `c_void_p`, every
int as `c_int`, and each entry returns `cudaGetLastError()` after its
launches, which the caller turns into an exception.

Nothing here runs at import: a CPU-only installation imports the package
and never reaches `nvcc`.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paml_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each entry point, per dtype suffix (f32 / f64)
_SIGNATURES = {
    "paml_pruning_fwd": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _P],
    "paml_pruning_bwd": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
build_log = ""          # nvcc's output (ptxas register/spill report)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cand.append(found)
    for c in cand:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME unset and no nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpaml_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_log
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cu = [str(s) for s in _sources() if s.suffix == ".cu"]
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(handle, f"{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")
