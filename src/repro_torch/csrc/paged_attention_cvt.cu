// Paged-attention decode for Hopper (sm_90a) over pages of another dtype
// than q, computing the reference model's decode_attention
// (src/repro/models/attention.py:102-124): q*scale rounded to the pages'
// dtype, the normalised weights exp(s - M) / L rounded to it, products
// summed in fp32, out in q's dtype. Replaces the Pallas TPU kernel
// paged_attention_kernel (src/repro/kernels/paged_attention/kernel.py:79)
// for such pages: fp8 e4m3 or int8 under a bf16 or fp32 q, bf16 under an
// fp32 q.
//
// One decode (paged_cvt_fwd) runs one of two designs, which the caller
// chooses (kernels/paged_attention/ops.py cvt_design):
// - the cluster design (paged_cluster.cuh): one launch, a thread block
//   cluster a (batch row, kv head) that reads v once and k once where a
//   block's scores fit its shared memory (k again for the overflow past
//   it), at every length a table holds;
// - the two-pass design (paged_cvt.cuh), for 8-bit rows whose kv heads TMA
//   cannot address (D 120 under an odd KV): four launches, pass 1 (the
//   split kernel in STATS mode, each partition's (m, l)), stats_merge (each
//   row's (M, L)), pass 2 (VALUES mode, each partition's sum of rounded
//   weights times v) and part_sum.
// The passes alone are entries too, for a decode whose cache sequence is
// cut over ranks: each rank runs pass 1 on its share, the ranks gather the
// (m, l) and merge them (paged_cvt_stats_merge), run pass 2 on their shares
// with the global (M, L), gather the sums and add them (paged_cvt_sum).
// Only the rows TMA cannot address take them there
// (kernels/paged_attention/ops.py split_design); the others take the two
// cluster launches of paged_attention_split.cu, then paged_cvt_sum.

#include "paged_cluster.cuh"

using namespace paged_cvt;

namespace {

template <typename F>
cudaError_t with_q(int q_dtype, F&& f) {
  if (q_dtype == 0) return f(float{});
  if (q_dtype == 1) return f(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

cudaError_t pass(int mode, const void* q, int q_dtype, const void* k_pages, const void* v_pages,
                 const void* tables, const void* lens, const float* stats, float* part_acc,
                 float* part_ml, int B, int KV, int G, int D, int max_blocks, int window,
                 float scale, int page_dtype, cudaStream_t s) {
  if (q_dtype != 0 && q_dtype != 1) return cudaErrorInvalidValue;
  return dispatch(page_dtype, D, G, [&](auto t, auto dp, auto nt) -> cudaError_t {
    using TK = decltype(t);
    constexpr int DP = decltype(dp)::value, NT = decltype(nt)::value;
    if (mode == STATS)
      return launch_split<TK, DP, NT, STATS, 1>(q, q_dtype, k_pages, v_pages, tables, lens,
                                                stats, part_acc, part_ml, B, KV, G, D,
                                                max_blocks, window, scale, s);
    return launch_split<TK, DP, NT, VALUES, 1>(q, q_dtype, k_pages, v_pages, tables, lens, stats,
                                               part_acc, part_ml, B, KV, G, D, max_blocks,
                                               window, scale, s);
  });
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
// <= 0: none. design 1: the cluster design (scratch unused); 0: the two
// passes, scratch holding B*KV*ceil(max_blocks/16)*G*(D+2) + B*KV*G*2 fp32
// values. Returns cudaGetLastError() after the last launch (or the first
// failure).
extern "C" int paged_cvt_fwd(const void* q, const void* k_pages, const void* v_pages,
                             const void* tables, const void* lens, void* out, void* scratch,
                             int B, int KV, int G, int D, int max_blocks, int window, float scale,
                             int q_dtype, int page_dtype, int design, int n_pages, void* stream) {
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
  float* stats = ml + (size_t)B * KV * n_part * G * 2;
  cudaError_t e = pass(STATS, q, q_dtype, k_pages, v_pages, tables, lens, nullptr, acc, ml, B,
                       KV, G, D, max_blocks, window, scale, page_dtype, s);
  if (e != cudaSuccess) return e;
  stats_merge<<<dim3(KV, B), 32, 0, s>>>(ml, static_cast<const int*>(lens), stats, KV, G,
                                        max_blocks, n_part, window);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = pass(VALUES, q, q_dtype, k_pages, v_pages, tables, lens, stats, acc, ml, B, KV, G, D,
           max_blocks, window, scale, page_dtype, s);
  if (e != cudaSuccess) return e;
  return with_q(q_dtype, [&](auto t) -> cudaError_t {
    using TQ = decltype(t);
    part_sum<TQ><<<dim3(KV, B), 128, 0, s>>>(acc, static_cast<const int*>(lens),
                                             static_cast<TQ*>(out), KV, G, D, max_blocks,
                                             n_part, window);
    return cudaGetLastError();
  });
}

// Pass 1 alone over a share of each sequence (lens counted from the
// table's first position, as paged_attention_partials): part_ml (B, KV,
// ceil(max_blocks/16), G, 2); partitions no block writes keep what the
// caller put there.
extern "C" int paged_cvt_stats(const void* q, const void* k_pages, const void* tables,
                               const void* lens, void* part_ml, int B, int KV, int G, int D,
                               int max_blocks, int window, float scale, int q_dtype,
                               int page_dtype, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (max_blocks < 1) return cudaErrorInvalidValue;
  return pass(STATS, q, q_dtype, k_pages, nullptr, tables, lens, nullptr, nullptr,
              static_cast<float*>(part_ml), B, KV, G, D, max_blocks, window, scale, page_dtype,
              static_cast<cudaStream_t>(stream));
}

// Every one of n_part partitions' (m, l) (B, KV, n_part, G, 2) merged into
// stats (B, KV, G, 2) = (M, L).
extern "C" int paged_cvt_stats_merge(const void* part_ml, void* stats, int B, int KV, int G,
                                     int n_part, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (G < 1 || n_part < 1) return cudaErrorInvalidValue;
  stats_merge<<<dim3(KV, B), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_ml), nullptr, static_cast<float*>(stats), KV, G,
      n_part * PART, n_part, 0);
  return cudaGetLastError();
}

// Pass 2 alone over a share, with the sequence's stats (B, KV, G, 2):
// part_acc (B, KV, ceil(max_blocks/16), G, D); partitions no block writes
// keep what the caller put there.
extern "C" int paged_cvt_values(const void* q, const void* k_pages, const void* v_pages,
                                const void* tables, const void* lens, const void* stats,
                                void* part_acc, int B, int KV, int G, int D, int max_blocks,
                                int window, float scale, int q_dtype, int page_dtype,
                                void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (max_blocks < 1) return cudaErrorInvalidValue;
  return pass(VALUES, q, q_dtype, k_pages, v_pages, tables, lens,
              static_cast<const float*>(stats), static_cast<float*>(part_acc), nullptr, B, KV,
              G, D, max_blocks, window, scale, page_dtype, static_cast<cudaStream_t>(stream));
}

// Every one of n_part partitions' sums (B, KV, n_part, G, D) added into
// out (B, KV, G, D) of out_dtype (0 fp32, 1 bf16).
extern "C" int paged_cvt_sum(const void* part_acc, void* out, int B, int KV, int G, int D,
                             int n_part, int out_dtype, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (G < 1 || D < 1 || n_part < 1) return cudaErrorInvalidValue;
  return with_q(out_dtype, [&](auto t) -> cudaError_t {
    using TQ = decltype(t);
    part_sum<TQ><<<dim3(KV, B), 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(part_acc), nullptr, static_cast<TQ*>(out), KV, G, D,
        n_part * PART, n_part, 0);
    return cudaGetLastError();
  });
}
