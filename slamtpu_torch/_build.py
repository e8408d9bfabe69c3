"""Build and load the hand-written CUDA kernels under csrc/.

Each `csrc/<name>.cu` exposes a plain C launch function and is compiled at
first use by nvcc into its own shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/slamtpu_torch/lib<name>-<hash>.so

then loaded with ctypes. The file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
`build()` starts one nvcc per missing library, all at once, and waits for
all of them. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "slamtpu_torch"
SOURCES = ("corner_response", "extract_patches", "nullspace4")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, in parallel.

    Returns {name: nvcc's output} for the sources compiled now (ptxas's
    register / shared-memory / spill summary among it); raises if any
    compile fails.
    """
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(f"{n}:\n{logs[n]}" for n in failed))
    return logs


def load(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C launch function `fn` of csrc/<name>.cu (built if needed), with
    its argtypes set and an int (cudaError_t) result."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    func = getattr(_loaded[name], fn)
    func.argtypes = argtypes
    func.restype = ctypes.c_int
    return func
