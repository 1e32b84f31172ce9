// K2's default mode over pages of another dtype than q under a sequence
// split (seq_shard_decode), computing the reference model's
// decode_attention (src/repro/models/attention.py:102-124) over one rank's
// share of every sequence: q*scale rounded to the pages' dtype, the
// weights exp(s - M) / L normalised by the WHOLE sequence's (M, L) and
// rounded to the pages' dtype, fp32 sums. Replaces the Pallas TPU kernel
// paged_attention_kernel (src/repro/kernels/paged_attention/kernel.py:79) in
// that form, for fp8 e4m3 or int8 pages under a bf16 or fp32 q and bf16
// pages under an fp32 q, wherever TMA can address a kv head's rows.
//
// Two launches of a thread block cluster a rank (paged_split_cluster.cuh,
// whose header gives the design and its bound): pass 1 (the share's scores
// and one (m, l)), then, once the ranks have gathered the (m, l), pass 2
// (the sequence's (M, L) merged from them, the share's sum of rounded
// weights times v from the stored scores); paged_cvt_sum of
// paged_attention_cvt.cu adds the ranks' sums. A library of its own, so
// that the cvt library's instances (the one-launch cluster and the two
// passes) compile as they did.

#include "paged_split_cluster.cuh"

using namespace paged_cvt;

// Pass 1 of the split cluster design over a share of each sequence (lens
// counted from the table's first position, as paged_cvt_stats): q
// (B,KV,G,D) of q_dtype (0 fp32, 1 bf16); k pages (P,16,KV,D) of page_dtype
// (1 bf16, 2 e4m3, 3 int8), n_pages = P; scores (B, KV, max_blocks, G, 16)
// fp32, written where the share's pages lie in the window; ml (B, KV, G, 2)
// fp32, the share's (m, l).
extern "C" int paged_cvt_share_stats(const void* q, const void* k_pages, const void* tables,
                                     const void* lens, void* scores, void* ml, int B, int KV,
                                     int G, int D, int max_blocks, int window, float scale,
                                     int q_dtype, int page_dtype, int n_pages, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (max_blocks < 1 || (q_dtype != 0 && q_dtype != 1)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scores);
  float* m = static_cast<float*>(ml);
  return dispatch(page_dtype, D, G, [&](auto t, auto, auto nt) -> cudaError_t {
    using TK = decltype(t);
    constexpr int NT = decltype(nt)::value;
    if (q_dtype == 0)
      return paged_split_cluster::launch_stats<TK, float, NT>(q, k_pages, tables, lens, sc, m, B,
                                                              KV, G, D, max_blocks, window,
                                                              scale, n_pages, s);
    if constexpr (std::is_same_v<TK, __nv_bfloat16>) {
      return cudaErrorInvalidValue;   // bf16 pages under a bf16 q: q's own dtype
    } else {
      return paged_split_cluster::launch_stats<TK, __nv_bfloat16, NT>(
          q, k_pages, tables, lens, sc, m, B, KV, G, D, max_blocks, window, scale, n_pages, s);
    }
  });
}

// Pass 2 of the split cluster design over the same share: v pages as pass
// 1's k pages; scores pass 1's; ml (B, KV, R, G, 2) fp32, the R shares' (m,
// l) gathered in position order; part (B, KV, G, D) fp32, the share's sum
// of the weights exp(s - M) / L rounded to the pages' dtype times v.
extern "C" int paged_cvt_share_values(const void* v_pages, const void* scores, const void* ml,
                                      int R, const void* tables, const void* lens, void* part,
                                      int B, int KV, int G, int D, int max_blocks, int window,
                                      int page_dtype, int n_pages, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (max_blocks < 1 || R < 1) return cudaErrorInvalidValue;
  return dispatch(page_dtype, D, G, [&](auto t, auto, auto nt) -> cudaError_t {
    using TK = decltype(t);
    constexpr int NT = decltype(nt)::value;
    return paged_split_cluster::launch_values<TK, NT>(
        v_pages, static_cast<const float*>(scores), static_cast<const float*>(ml), R, tables,
        lens, static_cast<float*>(part), B, KV, G, D, max_blocks, window, n_pages,
        static_cast<cudaStream_t>(stream));
  });
}
