"""ctypes bindings for the C++ host-side store ops.

``store_ops.cpp`` beside this file (the port's own copy of the JAX
package's source; a test holds their code lines identical) is compiled with
g++ on first use into ``emdr2_tpu_torch/_build/``. The bindings below are the JAX
package's; ``batch_context_format`` also counts its rows' token positions
(``utils/timing.py:count``). ``MMapIndexedDataset.batch_padded`` keeps its
pure-Python path if the build fails, as there; the evidence-index builder
does not (``retrieval/builder.py``): a failed build raises there.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from emdr2_tpu_torch.utils.timing import count

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
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


_FORMAT_BY_DTYPES = {
    (np.dtype(np.uint16), np.dtype(np.uint16)): "format_context_u16_u16",
    (np.dtype(np.int32), np.dtype(np.int32)): "format_context_i32_i32",
    (np.dtype(np.uint16), np.dtype(np.int32)): "format_context_u16_i32",
    (np.dtype(np.int32), np.dtype(np.uint16)): "format_context_i32_u16",
}


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


def batch_context_format(titles, texts, doc_ids: np.ndarray, max_len: int,
                         cls_id: int, sep_id: int, pad_id: int):
    """Format [CLS] title [SEP] text [SEP] pad rows for many (1-based)
    doc_ids straight from two MMapIndexedDatasets. Returns (ids, types)
    int32 [n, max_len]. Adds the rows' token positions (those not
    ``pad_id``) to ``batch_context_format.tokens`` and their slots to
    ``.slots``."""
    key = (np.dtype(titles.dtype), np.dtype(texts.dtype))
    fn = getattr(get_lib(), _FORMAT_BY_DTYPES[key])
    doc_ids = np.ascontiguousarray(doc_ids, np.int64)
    n = len(doc_ids)
    ids = np.empty((n, max_len), np.int32)
    types = np.empty((n, max_len), np.int32)
    t_bin = titles._bin.view(np.uint8)
    d_bin = texts._bin.view(np.uint8)
    fn(_ptr(t_bin, ctypes.c_uint8),
       _ptr(np.ascontiguousarray(titles.pointers, np.int64), ctypes.c_int64),
       _ptr(np.ascontiguousarray(titles.sizes, np.int32), ctypes.c_int32),
       _ptr(d_bin, ctypes.c_uint8),
       _ptr(np.ascontiguousarray(texts.pointers, np.int64), ctypes.c_int64),
       _ptr(np.ascontiguousarray(texts.sizes, np.int32), ctypes.c_int32),
       _ptr(doc_ids, ctypes.c_int64), ctypes.c_int64(n),
       ctypes.c_int64(max_len), ctypes.c_int32(cls_id),
       ctypes.c_int32(sep_id), ctypes.c_int32(pad_id),
       _ptr(ids, ctypes.c_int32), _ptr(types, ctypes.c_int32))
    count(batch_context_format, "tokens",
          n=int(np.count_nonzero(ids != pad_id)))
    count(batch_context_format, "slots", n=ids.size)
    return ids, types


batch_context_format.tokens = 0
batch_context_format.slots = 0
