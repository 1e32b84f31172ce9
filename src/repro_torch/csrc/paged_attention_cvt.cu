// Paged-attention decode for Hopper (sm_90a) over pages of another dtype
// than q, computing the reference model's decode_attention
// (src/repro/models/attention.py:102-124): q*scale rounded to the pages'
// dtype, the normalised weights exp(s - M) / L rounded to it, products
// summed in fp32, out in q's dtype. Replaces the Pallas TPU kernel
// paged_attention_kernel (src/repro/kernels/paged_attention/kernel.py:79)
// for such pages: fp8 e4m3 or int8 under a bf16 or fp32 q, bf16 under an
// fp32 q.
//
// One decode (paged_cvt_fwd) is one launch of the cluster design
// (paged_cluster.cuh): a thread block cluster a (batch row, kv head) that
// reads v once and k once where a block's scores fit its shared memory (k
// again for the overflow past it), at every length a table holds and
// through each of the pool's tensor maps (per kv head, over all heads,
// over token pairs: 8-bit rows of D 120 under an odd KV), whose bound and
// design the header gives. A decode whose cache sequence is cut over ranks
// takes the two cluster launches of paged_attention_split.cu, then the
// sum of the ranks' partials here (paged_cvt_sum).

#include "paged_cluster.cuh"

using namespace paged_cvt;

namespace {

template <typename F>
cudaError_t with_q(int q_dtype, F&& f) {
  if (q_dtype == 0) return f(float{});
  if (q_dtype == 1) return f(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

cudaError_t cluster(const void* q, int q_dtype, const void* k_pages, const void* v_pages,
                    const void* tables, const void* lens, void* out, int B, int KV, int G, int D,
                    int max_blocks, int window, float scale, int page_dtype, int n_pages,
                    cudaStream_t s) {
  if (q_dtype != 0 && q_dtype != 1) return cudaErrorInvalidValue;
  return dispatch(page_dtype, D, G, [&](auto t, auto, auto nt) -> cudaError_t {
    using TK = decltype(t);
    constexpr int NT = decltype(nt)::value;
    if (q_dtype == 0)
      return paged_cluster::launch_cluster<TK, float, NT>(q, k_pages, v_pages, tables, lens, out,
                                                          B, KV, G, D, max_blocks, window, scale,
                                                          n_pages, s);
    if constexpr (std::is_same_v<TK, __nv_bfloat16>) {
      return cudaErrorInvalidValue;   // bf16 pages under a bf16 q: q's own dtype
    } else {
      return paged_cluster::launch_cluster<TK, __nv_bfloat16, NT>(
          q, k_pages, v_pages, tables, lens, out, B, KV, G, D, max_blocks, window, scale,
          n_pages, s);
    }
  });
}

}  // namespace

// q (B,KV,G,D) of q_dtype (0 fp32, 1 bf16); pages (P,16,KV,D) of page_dtype
// (1 bf16, 2 e4m3, 3 int8), n_pages = P; out (B,KV,G,D) of q_dtype; window
// <= 0: none. Returns cudaGetLastError() after the launch (or the
// failure).
extern "C" int paged_cvt_fwd(const void* q, const void* k_pages, const void* v_pages,
                             const void* tables, const void* lens, void* out, int B, int KV,
                             int G, int D, int max_blocks, int window, float scale, int q_dtype,
                             int page_dtype, int n_pages, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (max_blocks < 1) return cudaErrorInvalidValue;
  return cluster(q, q_dtype, k_pages, v_pages, tables, lens, out, B, KV, G, D, max_blocks,
                 window, scale, page_dtype, n_pages, static_cast<cudaStream_t>(stream));
}

// Every one of n_part partials' sums (B, KV, n_part, G, D) added into out
// (B, KV, G, D) of out_dtype (0 fp32, 1 bf16): the ranks' shares of the
// sequence split (paged_attention_split.cu's pass 2).
extern "C" int paged_cvt_sum(const void* part_acc, void* out, int B, int KV, int G, int D,
                             int n_part, int out_dtype, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (G < 1 || D < 1 || n_part < 1) return cudaErrorInvalidValue;
  return with_q(out_dtype, [&](auto t) -> cudaError_t {
    using TQ = decltype(t);
    part_sum<TQ><<<dim3(KV, B), 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(part_acc), static_cast<TQ*>(out), KV, G, D, n_part);
    return cudaGetLastError();
  });
}
