"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

Each ``.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface, on first use, into ``emdr2_tpu_torch/_build/``
(git-ignored), named by the hash of the sources so an edit rebuilds. The
library is loaded with ctypes: pointers and the stream are passed as
``c_void_p``, sizes as ``c_int``, and every entry point returns the
``cudaGetLastError()`` of its launch, which :func:`check` turns into an
exception. :func:`launch` calls an entry point with the tensors' card as
the calling thread's current device: the launch and its
``cudaFuncSetAttribute`` go to the runtime's current device, which in a
thread of its own (an embedder on another card than its process's trainer)
need not be the tensors'. A missing ``nvcc`` or a failed build raises with the compiler's
output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

_OPS = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_OPS, "csrc")
_BUILD = os.path.join(os.path.dirname(_OPS), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# entry point -> argument types (pointers and the stream as c_void_p)
_P, _I = ctypes.c_void_p, ctypes.c_int
_U, _F, _L = ctypes.c_uint, ctypes.c_float, ctypes.c_longlong
_DROPOUT = [_U, _U, _I, _F, _F]      # seed, threshold, on, 1-rate, 1/(1-rate)
_SIGNATURES = {
    # ..., the scores' scale, the relative-position bias (or null)
    "emdr2_flash_self_attention_bf16":
        [_P] * 4 + [_I] * 4 + _DROPOUT + [_F, _P, _P],
    # ..., the scale, the bias and its gradient's partials (or nulls)
    "emdr2_flash_self_attention_bwd_bf16":
        [_P] * 7 + [_I] * 4 + _DROPOUT + [_F, _P, _P, _P],
    "emdr2_flash_self_attention_smem": [_P],
    # ..., the splits' scratch (acc, (m, l)), sizes, key_chunk, n_splits
    "emdr2_flash_cross_attention_bf16":
        [_P] * 7 + [_I] * 7 + _DROPOUT + [_F, _P],
    # ..., delta and the runs' dq scratch, ..., sizes, key_chunk, n_runs
    "emdr2_flash_cross_attention_bwd_bf16":
        [_P] * 10 + [_I] * 7 + _DROPOUT + [_F, _P],
    "emdr2_flash_cross_attention_bwd_layout": [_P],
    # q, k, v as (batch stride, row stride) in elements after the pointers
    "emdr2_fid_attention_bf16":
        [_P] * 6 + [_L, _I] * 3 + [_I] * 6 + _DROPOUT + [_P],
    # ... and dq, dk, dv likewise, after v's
    "emdr2_fid_attention_bwd_bf16":
        [_P] * 11 + [_L, _I] * 6 + [_I] * 6 + _DROPOUT + [_P],
    # ..., Lk, stages a block walks, blocks a (head, example)
    "emdr2_decode_attention_int8": [_P] * 8 + [_I] * 9 + [_P],
    "emdr2_decode_attention_layout": [_P],
    "emdr2_candidate_scan_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "emdr2_candidate_scan_i8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "emdr2_candidate_scan_tc_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _P],
    "emdr2_candidate_scan_tc_i8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "emdr2_candidate_scan_kernels": [_P, _I],
    # y, r (or null), out, elements, rank, extents of axes rank-3 and
    # rank-2, the last axis, row and head offsets, seed, threshold, scale
    "emdr2_dropout_add_bf16": [_P] * 3 + [_L] + [_I] * 4 + [_U] * 4
                              + [_F, _P],
    "emdr2_dropout_add_f32": [_P] * 3 + [_L] + [_I] * 4 + [_U] * 4
                             + [_F, _P],
    # x, weight, bias, y, rows, H, eps, grid
    "emdr2_layer_norm_bf16": [_P] * 4 + [_I, _I, _F, _I, _P],
    "emdr2_layer_norm_f32": [_P] * 4 + [_I, _I, _F, _I, _P],
    # x, dy, weight, dx, partials, dweight, dbias, rows, H, eps, groups
    "emdr2_layer_norm_bwd_bf16": [_P] * 7 + [_I, _I, _F, _I, _P],
    "emdr2_layer_norm_bwd_f32": [_P] * 7 + [_I, _I, _F, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()    # the library: the prefetch worker launches
                            # kernels beside the step


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
    """Compile the kernels if this source hash has no library yet: one
    ``nvcc -c`` per source, run in parallel, then one link. Returns
    ``{"path", "seconds", "built", "log"}`` (``log`` holds the compilers'
    output, e.g. ``-Xptxas -v`` register and shared-memory counts)."""
    path = library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "built": False, "log": ""}
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{path}.{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{stem}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", obj, src]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}")
    objs = [obj for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{stem}.tmp"
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)   # atomic: a concurrent loader never sees half
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return {"path": path, "seconds": time.perf_counter() - t0,
            "built": True, "log": "".join(log)}


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(entry: str, what: str, device: torch.device, *args) -> None:
    """Call the library's ``entry`` with ``device`` (the tensors' card) as
    the calling thread's current CUDA device, and raise (naming ``what``)
    if the launch failed."""
    lib = load()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args)
    check(err, what)


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
