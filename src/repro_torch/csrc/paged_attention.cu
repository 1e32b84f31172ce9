// Paged-attention decode for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: the Pallas TPU kernel paged_attention_kernel (body _paged_kernel)
// in src/repro/kernels/paged_attention/kernel.py.
//
// Computes one-token attention over a block-table-indexed paged KV pool.
// q (B,KV,G,D); k/v pages (P,16,KV,D); block_tables (B,max_blocks) int32
// page ids; lens[b] is the INCLUSIVE index of the newest token, so the
// sequence holds lens[b]+1 tokens; out (B,KV,G,D); fp32 or bf16.
//
// Bound on this card: each cached token's k and v row is read once and used
// for only 2*G*D multiply-adds, a few operations per byte against the ~295
// the H100 needs to leave the memory roof, so it is bound by HBM bytes:
// about sum_b (lens[b]+1)*KV*D*2*sizeof(elem) per layer.
//
// Design: one block per (kv head, batch) computes all G query rows of that
// group, so each page is read from device memory once and reused for the G
// queries; that reuse is the whole of GQA's saving in a bytes-bound kernel.
// The page loop ends at ceil((lens[b]+1)/16), where the TPU kernel still
// loaded every page up to max_blocks. The four warps split the pages
// (warp w takes pages w, w+4, ...); in a warp, lane (t, half) dots token t's
// k with the G queries over one half of the head dim (16-byte loads), the two
// halves meet in one shuffle, and the online-softmax update of the page runs
// across the 16 token lanes. For p.v each lane owns D/32 contiguous head-dim
// elements and sums over the page's 16 tokens. The warps' partial
// (m, l, acc) merge in shared memory at the end. Everything is fp32 with
// operands rounded to the pool dtype as the TPU kernel's are. Splitting one
// long sequence over several blocks, to fill the card at small batch, is
// later work.

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int PAGE = 16;
constexpr int WARPS = 4;
constexpr int GMAX = 8;  // most q heads per kv head the kernel takes

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode(const T* __restrict__ q, const T* __restrict__ k_pages,
             const T* __restrict__ v_pages, const int* __restrict__ tables,
             const int* __restrict__ lens, T* __restrict__ out, int KV, int G,
             int max_blocks, float scale) {
  constexpr int E = D / 32;                  // p.v elements per lane
  constexpr int HALF = D / 2;                // q.k elements per lane
  constexpr int CH = 16 / (int)sizeof(T);    // elements per 16-byte load
  constexpr int QLD = D + 1;                 // second half shifted one bank
  __shared__ float qs[GMAX][QLD];
  __shared__ float ps[WARPS][GMAX][PAGE];
  __shared__ float ms[WARPS][GMAX];
  __shared__ float ls[WARPS][GMAX];
  __shared__ float accs[WARPS][GMAX][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 15;
  const int half = lane >> 4;
  const size_t q_off = ((size_t)b * KV + kvh) * G * D;

  for (int i = tid; i < G * D; i += WARPS * 32) {
    const int g = i / D, d = i % D;
    qs[g][d + (d >= HALF ? 1 : 0)] = round_to<T>(to_f(q[q_off + i]) * scale);
  }
  __syncthreads();

  const int seq_len = lens[b] + 1;
  const int n_used = min((seq_len + PAGE - 1) / PAGE, max_blocks);
  const size_t tok_stride = (size_t)KV * D;

  float m[GMAX], l[GMAX], acc[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int j = warp; j < n_used; j += WARPS) {
    const size_t page_base =
        (size_t)tables[(size_t)b * max_blocks + j] * PAGE * tok_stride + (size_t)kvh * D;

    const T* kr = k_pages + page_base + t * tok_stride + half * HALF;
    const float* qh = &qs[0][half * (HALF + 1)];
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
#pragma unroll
    for (int c = 0; c < HALF; c += CH) {
      float kf[CH];
      load_f<CH>(kr + c, kf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < CH; ++e) s[g] = fmaf(qh[g * QLD + c + e], kf[e], s[g]);
        }
      }
    }

    const bool valid = j * PAGE + t < seq_len;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {  // G is the same in every lane: the shuffles stay converged
        float sg = s[g] + __shfl_xor_sync(0xffffffffu, s[g], 16);
        if (!valid) sg = NEG_INF;
        float mx = sg;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        const float p = valid ? expf(sg - m_new) : 0.f;
        float rs = p;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l[g] = l[g] * alpha + rs;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
        if (half == 0) ps[warp][g][t] = round_to<T>(p);
      }
    }
    __syncwarp();

    const T* vr = v_pages + page_base + lane * E;
#pragma unroll 4
    for (int tt = 0; tt < PAGE; ++tt) {
      float vf[E];
      load_f<E>(vr + tt * tok_stride, vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float p = ps[warp][g][tt];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
    __syncwarp();  // ps is rewritten by this warp's next page
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        ms[warp][g] = m[g];
        ls[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) accs[warp][g][lane * E + e] = acc[g][e];
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += WARPS * 32) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, ms[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(ms[w][g] - M);
      L += ls[w][g] * f;
      A += accs[w][g][d] * f;
    }
    out[q_off + i] = from_f<T>(L > 0.f ? A / L : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* lens, void* out, int B,
                   int KV, int G, int max_blocks, float scale,
                   cudaStream_t stream) {
  const dim3 grid(KV, B);
  paged_decode<T, D><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out), KV, G, max_blocks,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp,
                       const void* tables, const void* lens, void* out, int B,
                       int KV, int G, int max_blocks, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, kp, vp, tables, lens, out, B, KV, G, max_blocks, scale, stream);
    case 64: return launch<T, 64>(q, kp, vp, tables, lens, out, B, KV, G, max_blocks, scale, stream);
    case 128: return launch<T, 128>(q, kp, vp, tables, lens, out, B, KV, G, max_blocks, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lens, void* out, int B, int KV,
                                   int G, int D, int max_blocks, float scale,
                                   int dtype, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (G < 1 || G > GMAX || max_blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k_pages, v_pages, tables, lens, out, B, KV, G, max_blocks, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, tables, lens, out, B, KV, G, max_blocks, scale, s);
  return cudaErrorInvalidValue;
}
