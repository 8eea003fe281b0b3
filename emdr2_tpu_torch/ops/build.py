"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, on first use, into ``emdr2_tpu_torch/_build/``
(git-ignored), named by the hash of the sources so an edit rebuilds. The
library is loaded with ctypes: pointers and the stream are passed as
``c_void_p``, sizes as ``c_int``, and every entry point returns the
``cudaGetLastError()`` of its launch, which :func:`check` turns into an
exception. A missing ``nvcc`` or a failed build raises with the compiler's
output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_OPS = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_OPS, "csrc")
_BUILD = os.path.join(os.path.dirname(_OPS), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# entry point -> argument types (pointers and the stream as c_void_p)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "emdr2_flash_self_attention_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
    "emdr2_candidate_scan_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "emdr2_candidate_scan_i8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"emdr2_kernels_{h.hexdigest()[:16]}.so")


def build(extra_flags=()) -> dict:
    """Compile the kernels if this source hash has no library yet. Returns
    ``{"path", "seconds", "built", "log"}`` (``log`` holds the compiler's
    output, e.g. ``-Xptxas -v`` register and shared-memory counts)."""
    path = library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "built": False, "log": ""}
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, *[
        s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent loader never sees half a file
    return {"path": path, "seconds": seconds, "built": True,
            "log": proc.stdout + proc.stderr}


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
