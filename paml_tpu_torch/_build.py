"""Build and load the CUDA kernels of `csrc/`.

`nvcc` compiles each `csrc/*.cu` into its own shared library with a plain C
interface, at the first call, into `build/paml_tpu_torch/` beside the
package; the compilers for all sources run side by side.  A library's file
name carries a hash of its source, the shared headers (`csrc/*.cuh`) and
the flags, so an edited source is rebuilt and an unchanged one is loaded as
it is.  The libraries are loaded with `ctypes`: every pointer and the
stream are passed as `c_void_p`, every int as `c_int`, and each entry
returns `cudaGetLastError()` after its launches, which the caller turns
into an exception.

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
import types
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paml_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# the tangent kernels H1 / H2 (csrc/pruning_tangent.cuh), both encodings
_TAN_FWD = [_P, _I, _I] + [_P] * 4 + [_I, _P, _I] + [_P] * 5 + [_I] * 10 \
    + [_P]
_TAN_BWD = [_P, _I, _I] + [_P] * 4 + [_I, _P, _I] + [_P] * 11 + [_I] * 15 \
    + [_P]
# argtypes of each entry point (per dtype suffix f32 / f64), by source
_SIGNATURES = {
    "pruning": {
        "paml_pruning_fwd": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                             _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "paml_pruning_bwd": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _P],
        "paml_pruning_tan_fwd": _TAN_FWD,
        "paml_pruning_tan_bwd": _TAN_BWD,
    },
    "pruning_big": {
        "paml_big_fwd": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _I, _P],
        "paml_big_bwd": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P],
        "paml_big_tan_fwd": _TAN_FWD,
        "paml_big_tan_bwd": _TAN_BWD,
    },
    "eigh": {
        "paml_eigh": [_P, _P, _P, _P, _I, _I, _P],
        "paml_eigh_probe": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "quantile": {
        "paml_inc": [_I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P],
        "paml_inc_inv": [_I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P],
        "paml_mix_quantiles": [_I, _P, _I, _I, _P, _P, _P],
        "paml_polygamma": [_P, _I, _P, _P, _P],
    },
}
# suffixes of each source's entries: the dtype, and for the pruning walk
# the padded state count of the instance (`cuda_pruning.padded_states`)
_SUFFIXES = {"eigh": ("f64",), "quantile": ("f64",)}
_WALK_SUFFIXES = tuple(f"{d}_n{n}" for d in ("f32", "f64") for n in (32, 64))
# entries of a source whose suffixes differ from its own: the tangents are
# float64 alone (the Hessian's dtype)
_ENTRY_SUFFIXES = {f"paml_{pre}tan_{k}": ("f64_n32", "f64_n64")
                   for pre in ("pruning_", "big_") for k in ("fwd", "bwd")}

_lib = None
build_log = ""          # nvcc's output (ptxas register/spill report)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


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


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libpaml_{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> list[Path]:
    """Compile every source whose library does not exist yet, one `nvcc`
    per source, all started together."""
    global build_log
    srcs = _sources()
    outs = [library_path(s) for s in srcs]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [(s, o, o.with_suffix(f".{os.getpid()}.tmp"))
                for s, o in zip(srcs, outs) if not o.exists()]
        if todo:
            nvcc = _nvcc()
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                                       str(src)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for src, _, tmp in todo]
            logs = [p.communicate()[0] for p in procs]
            build_log = "".join(logs)
            for (src, _, _), p, log in zip(todo, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src.name} "
                                       f"({p.returncode}):\n{log}")
            for _, out, tmp in todo:
                os.replace(tmp, out)
    return outs


def lib() -> types.SimpleNamespace:
    """Every entry point of the kernel libraries (built at the first call),
    as attributes `<entry>_<f32|f64>`, the walk's `<entry>_<f32|f64>_n<N>`
    (N = 32, 64; its tangents' float64 alone)."""
    global _lib
    if _lib is None:
        fns = {}
        for src, path in zip(_sources(), build()):
            handle = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES[src.stem].items():
                for suffix in _ENTRY_SUFFIXES.get(
                        name, _SUFFIXES.get(src.stem, _WALK_SUFFIXES)):
                    fn = getattr(handle, f"{name}_{suffix}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[f"{name}_{suffix}"] = fn
        _lib = types.SimpleNamespace(**fns)
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")
