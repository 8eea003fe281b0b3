// Host-side hot loops for the token store and retrieval postprocess.
//
// The reference's equivalents are Python loops on the critical path:
// per-hit token fetch + format in get_topk/postprocess
// (the reference's megatron/model/emdr2_model.py:250-303,457-468) and the
// per-row evidence formatting in the index builder
// (megatron/data/orqa_wiki_dataset.py:85-120). These run every training
// step (B*K = 400 rows) and for all 21M rows per index refresh, so they get
// a native implementation here (the reference's native code budget went to
// CUDA softmax kernels instead; on TPU those are XLA-fused, and the host
// pipeline is what's left to accelerate).
//
// Exposed via ctypes (no pybind11 in this image): plain C ABI, raw pointers
// into numpy/memmap buffers. All token outputs are int32.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// ---- batched padded gather -------------------------------------------------
// out[r, :] = tokens(indices[r]) truncated/padded to max_len.
// bin: the raw .bin mmap; pointers/sizes: per-sequence byte offsets and
// token counts from the .idx header (MMapIndexedDataset layout).

#define DEFINE_GATHER(NAME, SRC_T)                                         \
  void NAME(const uint8_t* bin, const int64_t* pointers,                   \
            const int32_t* sizes, const int64_t* indices, int64_t n_rows,  \
            int64_t max_len, int32_t pad_id, int32_t* out) {               \
    for (int64_t r = 0; r < n_rows; ++r) {                                 \
      const int64_t idx = indices[r];                                      \
      const SRC_T* src =                                                   \
          reinterpret_cast<const SRC_T*>(bin + pointers[idx]);             \
      const int64_t n = std::min<int64_t>(sizes[idx], max_len);            \
      int32_t* dst = out + r * max_len;                                    \
      for (int64_t i = 0; i < n; ++i) dst[i] = (int32_t)src[i];            \
      for (int64_t i = n; i < max_len; ++i) dst[i] = pad_id;               \
    }                                                                      \
  }

DEFINE_GATHER(gather_padded_u8, uint8_t)
DEFINE_GATHER(gather_padded_i8, int8_t)
DEFINE_GATHER(gather_padded_i16, int16_t)
DEFINE_GATHER(gather_padded_u16, uint16_t)
DEFINE_GATHER(gather_padded_i32, int32_t)
DEFINE_GATHER(gather_padded_i64, int64_t)

// ---- evidence row formatting ------------------------------------------------
// For each doc id d (1-based): emit
//   [CLS] title(d) [SEP] text(d) ... [SEP] pad...   (ids)
//   0 ... 0 pad_id...                               (tokentypes)
// exactly as context_bert_format over title+[SEP]+text
// (orqa_wiki_dataset.py:68-120): content capped at max_len-1 then [SEP].
// title/text stores may have different dtypes; handled by the uint16/int32
// dispatch below (only combinations used in practice).

}  // extern "C" (template below needs C++ linkage)

template <typename TT, typename DT>
static inline void format_one(const uint8_t* title_bin, int64_t t_ptr,
                              int32_t t_size, const uint8_t* text_bin,
                              int64_t d_ptr, int32_t d_size, int64_t max_len,
                              int32_t cls_id, int32_t sep_id, int32_t pad_id,
                              int32_t* ids, int32_t* types) {
  const TT* title = reinterpret_cast<const TT*>(title_bin + t_ptr);
  const DT* text = reinterpret_cast<const DT*>(text_bin + d_ptr);
  int64_t w = 0;
  ids[w++] = cls_id;
  for (int32_t i = 0; i < t_size && w < max_len - 1; ++i)
    ids[w++] = (int32_t)title[i];
  if (w < max_len - 1) ids[w++] = sep_id;
  for (int32_t i = 0; i < d_size && w < max_len - 1; ++i)
    ids[w++] = (int32_t)text[i];
  ids[w++] = sep_id;
  for (int64_t i = 0; i < w; ++i) types[i] = 0;
  for (int64_t i = w; i < max_len; ++i) {
    ids[i] = pad_id;
    types[i] = pad_id;
  }
}

extern "C" {

#define DEFINE_FORMAT(NAME, TT, DT)                                          \
  void NAME(const uint8_t* title_bin, const int64_t* title_ptrs,             \
            const int32_t* title_sizes, const uint8_t* text_bin,             \
            const int64_t* text_ptrs, const int32_t* text_sizes,             \
            const int64_t* doc_ids, int64_t n_rows, int64_t max_len,         \
            int32_t cls_id, int32_t sep_id, int32_t pad_id, int32_t* ids,    \
            int32_t* types) {                                                \
    for (int64_t r = 0; r < n_rows; ++r) {                                   \
      const int64_t row = doc_ids[r] - 1; /* 1-based doc ids */              \
      format_one<TT, DT>(title_bin, title_ptrs[row], title_sizes[row],       \
                         text_bin, text_ptrs[row], text_sizes[row], max_len, \
                         cls_id, sep_id, pad_id, ids + r * max_len,          \
                         types + r * max_len);                               \
    }                                                                        \
  }

DEFINE_FORMAT(format_context_u16_u16, uint16_t, uint16_t)
DEFINE_FORMAT(format_context_i32_i32, int32_t, int32_t)
DEFINE_FORMAT(format_context_u16_i32, uint16_t, int32_t)
DEFINE_FORMAT(format_context_i32_u16, int32_t, uint16_t)

}  // extern "C"

// ---- full retrieval postprocess ---------------------------------------------
// The per-step B*K reader/teacher row builder (emdr2_model.py:250-376),
// including the neighbor-window budget logic of
// query_extended_context_t5_format. Exact behavioral parity with
// emdr2_tpu/data/postprocess.py (the Python version stays as the golden
// reference; see tests/test_postprocess.py).

#include <vector>

namespace {

// dtype codes: 0 = uint16, 1 = int32 (the two MMIDIDX token dtypes in use)
inline int64_t copy_tokens(const uint8_t* bin, int64_t ptr, int64_t size,
                           int dtype, int32_t* dst, int64_t cap) {
  const int64_t n = std::min<int64_t>(size, cap);
  if (dtype == 0) {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(bin + ptr);
    for (int64_t i = 0; i < n; ++i) dst[i] = (int32_t)s[i];
  } else {
    std::memcpy(dst, bin + ptr, n * sizeof(int32_t));
  }
  return n;
}

inline void fetch_doc(const uint8_t* bin, const int64_t* ptrs,
                      const int32_t* sizes, int dtype, int64_t row,
                      std::vector<int32_t>* out) {
  out->resize((size_t)sizes[row]);
  copy_tokens(bin, ptrs[row], sizes[row], dtype, out->data(), sizes[row]);
}

// prefix(query ++ title ++ [SEP]) ++ extended context ++ [SEP] ++ pad
// (query_extended_context_t5_format; emdr2_model.py:306-359)
inline void extended_row(const std::vector<int32_t>& prefix,
                         const std::vector<int32_t> docs[3], int n_docs,
                         int main_pos /* 0 first, 1 middle, -1 last */,
                         int64_t Lr, int32_t sep_id, int32_t pad_id,
                         int32_t* out) {
  const int64_t budget =
      std::max<int64_t>(0, Lr - (int64_t)prefix.size() - 1);
  const int main_i = main_pos == -1 ? n_docs - 1 : main_pos;
  const std::vector<int32_t>& main = docs[main_i];
  std::vector<int32_t> ctx;
  ctx.reserve((size_t)budget);
  if ((int64_t)main.size() > budget || n_docs == 1) {
    ctx.assign(main.begin(), main.begin() + std::min<int64_t>(
        main.size(), budget));
  } else {
    const int64_t extra = budget - (int64_t)main.size();
    if (main_pos == 0) {
      ctx = main;
      for (int d = 1; d < n_docs && (int64_t)ctx.size() < budget; ++d)
        for (size_t i = 0; i < docs[d].size()
             && (int64_t)ctx.size() - (int64_t)main.size() < extra; ++i)
          ctx.push_back(docs[d][i]);
    } else if (main_pos == -1) {
      std::vector<int32_t> left;
      for (int d = 0; d < n_docs - 1; ++d)
        left.insert(left.end(), docs[d].begin(), docs[d].end());
      if ((int64_t)left.size() > extra)  // keep the TAIL, Python's
        left.erase(left.begin(),         // left[len(left)-extra+1:]
                   left.begin() + (left.size() - extra + 1));
      ctx = left;
      ctx.insert(ctx.end(), main.begin(), main.end());
    } else {  // middle of a 3-window
      std::vector<int32_t> left = docs[0];
      if ((int64_t)left.size() > extra) {
        left.erase(left.begin(), left.begin() + (left.size() - extra + 1));
        ctx = left;
        ctx.insert(ctx.end(), main.begin(), main.end());
      } else {
        ctx = left;
        ctx.insert(ctx.end(), main.begin(), main.end());
        if (n_docs == 3) {
          const int64_t remaining = extra - (int64_t)left.size();
          for (int64_t i = 0;
               i < std::min<int64_t>(remaining, (int64_t)docs[2].size()); ++i)
            ctx.push_back(docs[2][i]);
        }
      }
    }
  }
  int64_t w = 0;
  for (size_t i = 0; i < prefix.size() && w < Lr; ++i) out[w++] = prefix[i];
  for (size_t i = 0; i < ctx.size() && w < Lr; ++i) out[w++] = ctx[i];
  if (w < Lr) out[w++] = sep_id;
  for (; w < Lr; ++w) out[w] = pad_id;
}

// query ++ title ++ [SEP] ++ context capped at Lr-1 ++ [SEP] ++ pad
// (query_single_context_t5_format; emdr2_model.py:362-376)
inline void single_row(const std::vector<int32_t>& prefix,
                       const std::vector<int32_t>& context, int64_t Lr,
                       int32_t sep_id, int32_t pad_id, int32_t* out) {
  int64_t w = 0;
  for (size_t i = 0; i < prefix.size() && w < Lr - 1; ++i)
    out[w++] = prefix[i];
  for (size_t i = 0; i < context.size() && w < Lr - 1; ++i)
    out[w++] = context[i];
  out[w++] = sep_id;
  for (; w < Lr; ++w) out[w] = pad_id;
}

}  // namespace

extern "C" {

// Returns per-query survivor counts in k_out (caller asserts == topk).
// win/pos/wlen: per 0-based corpus row, the <=3-doc title window (1-based
// ids), the hit position code (0/1/-1) and the window length.
void postprocess_batch(
    const uint8_t* title_bin, const int64_t* title_ptrs,
    const int32_t* title_sizes, int title_dtype, const uint8_t* text_bin,
    const int64_t* text_ptrs, const int32_t* text_sizes, int text_dtype,
    const int64_t* win, const int8_t* pos, const int8_t* wlen,
    const int32_t* query_ids, const int32_t* query_lens,
    const int64_t* query_uids, const int64_t* topk_ids, int64_t B,
    int64_t Kp, int64_t topk, int64_t Lq_stride, int64_t Lc, int64_t Lr,
    int32_t cls_id, int32_t sep_id, int32_t pad_id, int32_t* ctx_ids,
    int32_t* ctx_types, int32_t* reader, int32_t* reader_one,
    int32_t* k_out) {
  std::vector<int32_t> title, prefix;
  std::vector<int32_t> docs[3];
  for (int64_t b = 0; b < B; ++b) {
    const int64_t quid = query_uids[b];
    const int32_t* query = query_ids + b * Lq_stride;
    const int64_t qlen = query_lens[b];
    int64_t k = 0;
    for (int64_t j = 0; j < Kp && k < topk; ++j) {
      const int64_t eid = topk_ids[b * Kp + j];
      if (eid == quid) continue;
      const int64_t row = eid - 1;  // 1-based doc ids

      fetch_doc(title_bin, title_ptrs, title_sizes, title_dtype, row, &title);
      const int n_docs = (int)wlen[row];
      for (int d = 0; d < n_docs; ++d)
        fetch_doc(text_bin, text_ptrs, text_sizes, text_dtype,
                  win[row * 3 + d] - 1, &docs[d]);
      const int main_pos = (int)pos[row];
      const int main_i = main_pos == -1 ? n_docs - 1 : main_pos;

      // BERT context row: [CLS] title [SEP] main_ctx [SEP] pad
      {
        int32_t* ids = ctx_ids + (b * topk + k) * Lc;
        int32_t* types = ctx_types + (b * topk + k) * Lc;
        int64_t w = 0;
        ids[w++] = cls_id;
        for (size_t i = 0; i < title.size() && w < Lc - 1; ++i)
          ids[w++] = title[i];
        if (w < Lc - 1) ids[w++] = sep_id;
        const std::vector<int32_t>& main = docs[main_i];
        for (size_t i = 0; i < main.size() && w < Lc - 1; ++i)
          ids[w++] = main[i];
        ids[w++] = sep_id;
        for (int64_t i = 0; i < w; ++i) types[i] = 0;
        for (int64_t i = w; i < Lc; ++i) {
          ids[i] = pad_id;
          types[i] = pad_id;
        }
      }

      prefix.assign(query, query + qlen);
      prefix.insert(prefix.end(), title.begin(), title.end());
      prefix.push_back(sep_id);
      extended_row(prefix, docs, n_docs, main_pos, Lr, sep_id, pad_id,
                   reader + (b * topk + k) * Lr);
      single_row(prefix, docs[main_i], Lr, sep_id, pad_id,
                 reader_one + (b * topk + k) * Lr);
      ++k;
    }
    k_out[b] = (int32_t)k;
  }
}

}  // extern "C"
