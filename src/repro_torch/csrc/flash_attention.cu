// Flash-attention prefill for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: the Pallas TPU kernel flash_attention_kernel (body _flash_kernel)
// in src/repro/kernels/flash_attention/kernel.py.
//
// Computes causal, optionally sliding-window GQA attention. q (B,Sq,H,D),
// k/v (B,Skv,KV,D), out (B,Sq,H,D), all contiguous, fp32 or bf16; q head h
// reads kv head h / (H/KV). lens[b] is the EXCLUSIVE valid kv length; a row
// with no valid key writes 0. Query positions start at 0.
//
// Bound on this card: at the main path's prompts (S 512-2048, 24 heads,
// D 128) the work is about 2*2*S^2/2*H*D operations per layer against
// (2*S*H + 2*S*KV)*D elements moved, far above the ~295 operations per byte
// where the H100 stops being memory bound, so it is bound by arithmetic.
//
// Design: one block of 256 threads per (64-row q tile, q head, batch). The
// TPU's sequential kv grid axis and its VMEM scratch become a loop inside the
// block over 64-key tiles of k and v staged in shared memory, converted to
// fp32 (rows padded by one word, so the 16 lanes of a row group read 16
// different banks). The loop starts at the window's left edge and stops at
// the causal diagonal and at lens[b]: masked-out tiles are never loaded,
// where the TPU kernel skipped only their arithmetic. Ragged Sq/Skv and
// k_pos >= lens[b] are masked inside, so the host pads nothing. Each thread
// owns 4 q rows x 4 keys of the score tile and 4 rows x D/16 columns of the
// output; the running max, sum and accumulator stay in registers in fp32.
// The products run on the FMA units in fp32 (operands rounded to the input
// dtype, as the TPU kernel's bf16 MXU operands are): this first version is
// right before it is fast, and is slow against its arithmetic bound.
// Moving the products to wgmma with TMA-fed tiles is the next step.

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per staged tile
constexpr int THREADS = 256;  // 16 row groups x 16 lanes

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ lens,
          T* __restrict__ out, int Sq, int Skv, int H, int KV, int window,
          float scale) {
  constexpr int LD = D + 1;   // padded row of the q/k/v tiles
  constexpr int LP = BK + 1;  // padded row of the probability tile
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;    // key and output-column lane
  const int ty = tid >> 4;    // row group: rows 4*ty .. 4*ty+3
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const int len_b = min(lens[b], Skv);
  const int q_end = min(q_start + BQ, Sq);
  const int k_end = min(len_b, q_end);  // causal: no key past the last row
  int k_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qp = q_start + r;
    float x = 0.f;
    if (qp < Sq)
      x = round_to<T>(to_f(q[(((size_t)b * Sq + qp) * H + h) * D + d]) * scale);
    Qs[r * LD + d] = x;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k_start = k_begin; k_start < k_end; k_start += BK) {
    __syncthreads();  // the previous tile is consumed and the q tile written
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const int kp = k_start + c;
      float kx = 0.f, vx = 0.f;
      if (kp < Skv) {
        const size_t off = (((size_t)b * Skv + kp) * KV + kvh) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      Ks[c * LD + d] = kx;
      Vs[c * LD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; a row's 64 scores lie in the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_start + 4 * ty + i;
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k_start + tx + 16 * j;
        valid[j] = kp < len_b && kp <= qp && (window <= 0 || kp > qp - window);
        if (!valid[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(4 * ty + i) * LP + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a row group's probabilities were written by its own warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(4 * ty + i) * LP + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_start + 4 * ty + i;
    if (qp >= Sq) continue;
    T* o = out + (((size_t)b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      o[tx + 16 * j] = from_f<T>(l[i] > 0.f ? acc[i][j] / l[i] : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lens, void* out, int B, int Sq, int Skv, int H,
                   int KV, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;  // the opt-in above 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lens),
      static_cast<T*>(out), Sq, Skv, H, KV, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* lens, void* out, int B, int Sq, int Skv,
                       int H, int KV, int window, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* lens, void* out, int B, int Sq,
                                   int Skv, int H, int KV, int D, int window,
                                   float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, s);
  return cudaErrorInvalidValue;
}
