// Paged-attention decode for Hopper (sm_90a) over pages of another dtype
// than q, upcast to q's: the reference's decode_unroll lever
// (src/repro/models/transformer.py:485-488) casts the cache to q's dtype
// before decode_attention, so q*scale and the weights round to q's dtype,
// not the pages'; an fp32 cache under a bf16 q is rounded down to bf16 on
// load, as the reference's astype rounds it. One decode (paged_upcast_fwd)
// runs one of two designs, which the caller chooses
// (kernels/paged_attention/ops.py upcast_design):
// - the cluster design (paged_cluster_upcast.cuh), for fp8 e4m3 or int8
//   pages under a bf16 q at every head dim and kv head count (8-bit rows of
//   D 120 under an odd KV through paged_cluster's paired map): one launch,
//   a thread block cluster a (batch row, kv head) that reads each page's k
//   and v once by TMA, an online softmax a block, merged through
//   distributed shared memory;
// - the split design: the one-pass split kernel of paged_attention.cu with
//   its pages converted on load (paged_cvt.cuh's paged_split_cvt; a bf16
//   q's q*scale and weights as bf16, an fp32 q's as three bf16 terms
//   each), then cvt_merge; for an fp32 q and fp32 pages under a bf16 q.
//   Its split half alone is paged_upcast_partials.
// Replaces the Pallas TPU kernel paged_attention_kernel
// (src/repro/kernels/paged_attention/kernel.py:79) for such pages; bounds
// and designs in the two headers.

#include "paged_cluster_upcast.cuh"

using namespace paged_cvt;

namespace {

cudaError_t split(const void* q, int q_dtype, const void* k_pages, const void* v_pages,
                  const void* tables, const void* lens, float* part_acc, float* part_ml, int B,
                  int KV, int G, int D, int max_blocks, int window, float scale, int page_dtype,
                  cudaStream_t s) {
  if (q_dtype == 1 && page_dtype == PAGE_BF16) return cudaErrorInvalidValue;  // q's own dtype
  if (q_dtype != 0 && q_dtype != 1) return cudaErrorInvalidValue;
  return dispatch<true>(page_dtype, D, G, [&](auto t, auto dp, auto nt) -> cudaError_t {
    using TK = decltype(t);
    constexpr int DP = decltype(dp)::value, NT = decltype(nt)::value;
    if constexpr (std::is_same_v<TK, float>) {  // under a bf16 q only: fp32 is q's own else
      if (q_dtype != 1) return cudaErrorInvalidValue;
      return launch_split<TK, DP, NT, 1>(q, 1, k_pages, v_pages, tables, lens, part_acc,
                                         part_ml, B, KV, G, D, max_blocks, window, scale, s);
    } else {
      if (q_dtype == 1) {
        if constexpr (std::is_same_v<TK, __nv_bfloat16>) {
          return cudaErrorInvalidValue;
        } else {
          return launch_split<TK, DP, NT, 1>(q, 1, k_pages, v_pages, tables, lens, part_acc,
                                             part_ml, B, KV, G, D, max_blocks, window, scale,
                                             s);
        }
      }
      return launch_split<TK, DP, NT, 3>(q, 0, k_pages, v_pages, tables, lens, part_acc,
                                         part_ml, B, KV, G, D, max_blocks, window, scale, s);
    }
  });
}

cudaError_t cluster(const void* q, int q_dtype, const void* k_pages, const void* v_pages,
                    const void* tables, const void* lens, void* out, int B, int KV, int G, int D,
                    int max_blocks, int window, float scale, int page_dtype, int n_pages,
                    cudaStream_t s) {
  if (q_dtype != 1 || D < 8 || D > 128 || D % 8 || G < 1 || G > GMAX)
    return cudaErrorInvalidValue;   // a bf16 q only
  auto with_nt = [&](auto t) -> cudaError_t {
    using TK = decltype(t);
    if (G <= NTILE)
      return paged_cluster_upcast::launch_upcast<TK, 1>(q, k_pages, v_pages, tables, lens, out,
                                                        B, KV, G, D, max_blocks, window, scale,
                                                        n_pages, s);
    return paged_cluster_upcast::launch_upcast<TK, 2>(q, k_pages, v_pages, tables, lens, out, B,
                                                      KV, G, D, max_blocks, window, scale,
                                                      n_pages, s);
  };
  if (page_dtype == PAGE_E4M3) return with_nt(E4M3{});
  if (page_dtype == PAGE_INT8) return with_nt(int8_t{});
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B,KV,G,D) of q_dtype (0 fp32, 1 bf16); pages (P,16,KV,D) of page_dtype
// (1 bf16 under an fp32 q, 2 e4m3, 3 int8, 4 fp32 under a bf16 q); out
// (B,KV,G,D) of q_dtype; window <= 0: none. design 1: the cluster (n_pages
// the pool's pages, for its tensor maps; no scratch); 0: the split, whose
// scratch holds B*KV*ceil(max_blocks/16)*G*(D+2) fp32 values. Returns
// cudaGetLastError() after the last launch (or the failure).
extern "C" int paged_upcast_fwd(const void* q, const void* k_pages, const void* v_pages,
                                const void* tables, const void* lens, void* out, void* scratch,
                                int B, int KV, int G, int D, int max_blocks, int window,
                                float scale, int q_dtype, int page_dtype, int design, int n_pages,
                                void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (max_blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1)
    return cluster(q, q_dtype, k_pages, v_pages, tables, lens, out, B, KV, G, D, max_blocks,
                   window, scale, page_dtype, n_pages, s);
  if (design != 0) return cudaErrorInvalidValue;
  const int n_part = (max_blocks + PART - 1) / PART;
  float* acc = static_cast<float*>(scratch);
  float* ml = acc + (size_t)B * KV * n_part * G * D;
  const cudaError_t e = split(q, q_dtype, k_pages, v_pages, tables, lens, acc, ml, B, KV, G, D,
                              max_blocks, window, scale, page_dtype, s);
  if (e != cudaSuccess) return e;
  if (q_dtype == 1)
    cvt_merge<__nv_bfloat16><<<dim3(KV, B), 128, 0, s>>>(
        acc, ml, static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), KV, G, D,
        max_blocks, n_part, window);
  else
    cvt_merge<float><<<dim3(KV, B), 128, 0, s>>>(acc, ml, static_cast<const int*>(lens),
                                                 static_cast<float*>(out), KV, G, D,
                                                 max_blocks, n_part, window);
  return cudaGetLastError();
}

// The split kernel alone (paged_attention_partials' contract): each
// partition's fp32 (acc, (m, l)) of the upcast pages; the partitions no
// block writes keep what the caller put there. paged_attention.cu's
// paged_merge_fwd merges them.
extern "C" int paged_upcast_partials(const void* q, const void* k_pages, const void* v_pages,
                                     const void* tables, const void* lens, void* part_acc,
                                     void* part_ml, int B, int KV, int G, int D, int max_blocks,
                                     int window, float scale, int q_dtype, int page_dtype,
                                     void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (max_blocks < 1) return cudaErrorInvalidValue;
  return split(q, q_dtype, k_pages, v_pages, tables, lens, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), B, KV, G, D, max_blocks, window, scale, page_dtype,
               static_cast<cudaStream_t>(stream));
}
