"""ctypes bindings for the C++ host-side store ops.

The C++ source is shared with the JAX package: ``emdr2_tpu/native/
store_ops.cpp`` is compiled by file path with g++ on first use (no Python
import of that package) into ``emdr2_tpu_torch/_build/``. The bindings below
are the JAX package's, unchanged; callers keep their pure-Python paths if the
build fails, as there.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "emdr2_tpu", "native",
                    "store_ops.cpp")
_BUILD = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD, "_store_ops.so")

_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)   # atomic: a concurrent build never sees half a file


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _build()
        _lib = ctypes.CDLL(_SO)
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


_GATHER_BY_DTYPE = {
    np.dtype(np.uint8): "gather_padded_u8",
    np.dtype(np.int8): "gather_padded_i8",
    np.dtype(np.int16): "gather_padded_i16",
    np.dtype(np.uint16): "gather_padded_u16",
    np.dtype(np.int32): "gather_padded_i32",
    np.dtype(np.int64): "gather_padded_i64",
}


def batch_gather_padded(bin_buf: np.ndarray, pointers: np.ndarray,
                        sizes: np.ndarray, dtype: np.dtype,
                        indices: np.ndarray, max_len: int,
                        pad_id: int) -> np.ndarray:
    """Gather sequences indices[i] from an mmap .bin buffer into an
    [n, max_len] int32 matrix (truncate/pad)."""
    lib = get_lib()
    fn = getattr(lib, _GATHER_BY_DTYPE[np.dtype(dtype)])
    n = len(indices)
    out = np.empty((n, max_len), np.int32)
    bin_u8 = bin_buf.view(np.uint8) if bin_buf.dtype != np.uint8 else bin_buf
    pointers = np.ascontiguousarray(pointers, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int32)
    indices = np.ascontiguousarray(indices, np.int64)
    fn(_ptr(bin_u8, ctypes.c_uint8), _ptr(pointers, ctypes.c_int64),
       _ptr(sizes, ctypes.c_int32), _ptr(indices, ctypes.c_int64),
       ctypes.c_int64(n), ctypes.c_int64(max_len), ctypes.c_int32(pad_id),
       _ptr(out, ctypes.c_int32))
    return out


_POSTPROCESS_DTYPES = {np.dtype(np.uint16): 0, np.dtype(np.int32): 1}


def batch_postprocess(titles, texts, win: np.ndarray, pos: np.ndarray,
                      wlen: np.ndarray, query_ids: np.ndarray,
                      query_lens: np.ndarray, query_uids: np.ndarray,
                      topk_ids: np.ndarray, topk: int, retriever_seq_len: int,
                      reader_seq_len: int, cls_id: int, sep_id: int,
                      pad_id: int):
    """C++ fast path for the full retrieval postprocess
    (``data/postprocess.py:postprocess_retrieved`` is the golden reference).
    titles/texts are MMapIndexedDatasets; win/pos/wlen the corpus
    neighbour table (``EvidenceCorpus.neighbour_table``). Returns
    (ctx_ids, ctx_types, reader, reader_one, k_out)."""
    lib = get_lib()
    title_dt = _POSTPROCESS_DTYPES[np.dtype(titles.dtype)]
    text_dt = _POSTPROCESS_DTYPES[np.dtype(texts.dtype)]
    B = len(query_uids)
    Kp = topk_ids.shape[1]
    Lc, Lr = retriever_seq_len, reader_seq_len
    query_ids = np.ascontiguousarray(query_ids, np.int32)
    ctx_ids = np.empty((B, topk, Lc), np.int32)
    ctx_types = np.empty((B, topk, Lc), np.int32)
    reader = np.empty((B, topk, Lr), np.int32)
    reader_one = np.empty((B, topk, Lr), np.int32)
    k_out = np.empty((B,), np.int32)
    lib.postprocess_batch(
        _ptr(titles._bin.view(np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(titles.pointers, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(titles.sizes, np.int32), ctypes.c_int32),
        ctypes.c_int(title_dt),
        _ptr(texts._bin.view(np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(texts.pointers, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(texts.sizes, np.int32), ctypes.c_int32),
        ctypes.c_int(text_dt),
        _ptr(np.ascontiguousarray(win, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(pos, np.int8), ctypes.c_int8),
        _ptr(np.ascontiguousarray(wlen, np.int8), ctypes.c_int8),
        _ptr(query_ids, ctypes.c_int32),
        _ptr(np.ascontiguousarray(query_lens, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(query_uids, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(topk_ids, np.int64), ctypes.c_int64),
        ctypes.c_int64(B), ctypes.c_int64(Kp), ctypes.c_int64(topk),
        ctypes.c_int64(query_ids.shape[1]), ctypes.c_int64(Lc),
        ctypes.c_int64(Lr), ctypes.c_int32(cls_id), ctypes.c_int32(sep_id),
        ctypes.c_int32(pad_id),
        _ptr(ctx_ids, ctypes.c_int32), _ptr(ctx_types, ctypes.c_int32),
        _ptr(reader, ctypes.c_int32), _ptr(reader_one, ctypes.c_int32),
        _ptr(k_out, ctypes.c_int32))
    return ctx_ids, ctx_types, reader, reader_one, k_out
