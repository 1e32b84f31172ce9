// The kernels of the flash-attention prefill (K1), compiled once for each
// masking mode: flash_attention.cu defines FLASH_CAUSAL 1 (the causal
// instances, the main path's; their code is the same whether or not the
// other mode exists) and flash_attention_noncausal.cu FLASH_CAUSAL 0 (every
// key below lens[b], Sq and Skv independent: the reference wrapper's
// causal=False). Each defines FLASH_ENTRY, its C entry's name. The design
// notes are in flash_attention.cu.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

#ifndef FLASH_CAUSAL
#error "define FLASH_CAUSAL (1 or 0) and FLASH_ENTRY before including flash_attention.cuh"
#endif

namespace {

using namespace repro_torch;
namespace hw = repro_torch::hopper;

// ------------------------------------------------------------ fp32 (SIMT)
constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per staged tile
constexpr int THREADS = 256;  // 16 row groups x 16 lanes

template <int D>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ lens,
               float* __restrict__ out, int Sq, int Skv, int H, int KV, int window,
               float scale) {
  constexpr int LD = D + 1;   // padded row of the q/k/v tiles
  constexpr int LP = BK + 1;  // padded row of the probability tile
  constexpr int DC = (D + 15) / 16;  // output columns per thread (past D: none)
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
#if FLASH_CAUSAL
  const int k_end = min(len_b, q_end);  // causal: no key past the last row
#else
  const int k_end = len_b;
#endif
  int k_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qp = q_start + r;
    Qs[r * LD + d] = qp < Sq ? q[(((size_t)b * Sq + qp) * H + h) * D + d] * scale : 0.f;
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
        kx = k[off];
        vx = v[off];
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
#if FLASH_CAUSAL
        valid[j] = kp < len_b && kp <= qp && (window <= 0 || kp > qp - window);
#else
        valid[j] = kp < len_b && (window <= 0 || kp > qp - window);
#endif
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
        Ps[(4 * ty + i) * LP + tx + 16 * j] = p;
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
      for (int j = 0; j < DC; ++j)
        vv[j] = D % 16 == 0 || tx + 16 * j < D ? Vs[c * LD + tx + 16 * j] : 0.f;
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
    float* o = out + (((size_t)b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (D % 16 == 0 || tx + 16 * j < D) o[tx + 16 * j] = l[i] > 0.f ? acc[i][j] / l[i] : 0.f;
  }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* lens,
                        void* out, int B, int Sq, int Skv, int H, int KV, int window,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<D>();
  static bool attr_set = false;  // the opt-in above 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_simt<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_simt<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lens),
      static_cast<float*>(out), Sq, Skv, H, KV, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------- bf16 (wgmma)
constexpr int TC_WGS = 2;                 // consumer warpgroups, 64 q rows each
constexpr int TC_BQ = 64 * TC_WGS;        // q rows per block
constexpr int TC_BK = 128;                // keys per k/v tile (the N of S = Q K^T)
constexpr int TC_STAGES = 2;              // k/v ring depth
constexpr int TC_THREADS = 128 * TC_WGS + 32;  // + one producer warp
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory geometry of one head dim. A tile of rows x D is stored as
// DP/CE column blocks of rows x CE bf16, each row SW bytes in TMA's
// swizzle; DP is D, or D rounded up to whole 64-column blocks (80, 112,
// 120 -> 128), the columns past D zero-filled by TMA.
template <int D>
struct TcTile {
  static constexpr int DP = D <= 64 ? D : (D + 63) / 64 * 64;  // head dim in shared memory
  static constexpr int SW = DP * 2 >= 128 ? 128 : DP * 2;  // swizzle row, bytes
  static constexpr int CE = SW / 2;                      // bf16 per row of a block
  static constexpr int NCB = DP / CE;                    // column blocks
  static constexpr int Q_BLOCK = TC_BQ * SW;             // bytes of one q column block
  static constexpr int KV_BLOCK = TC_BK * SW;            // bytes of one k/v column block
  static constexpr int Q_BYTES = TC_BQ * DP * 2;
  static constexpr int KV_BYTES = TC_BK * DP * 2;
  static constexpr int BARS = 1 + 3 * TC_STAGES;
  // 1024 bytes of slack to align the tiles to the swizzle pattern's period
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * TC_STAGES * KV_BYTES + 8 * BARS;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ lens,
                __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H, int KV,
                int window, float scale) {
  using T = TcTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + T::Q_BYTES;                    // TC_STAGES k tiles
  uint8_t* Vs = Ks + TC_STAGES * T::KV_BYTES;       // TC_STAGES v tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + TC_STAGES * T::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + TC_STAGES;
  uint64_t* empty = bars + 1 + 2 * TC_STAGES;

  const int tid = threadIdx.x;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int len_b = min(lens[b], Skv);
#if FLASH_CAUSAL
  const int k_end = min(len_b, min(q_start + TC_BQ, Sq));  // causal: no key past the last row
#else
  const int k_end = len_b;
#endif
  int k_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  k_begin = (k_begin / TC_BK) * TC_BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + TC_BK - 1) / TC_BK : 0;

  if (tid == 0) {
    hw::mbar_init(q_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      hw::mbar_init(&k_full[s], 1);
      hw::mbar_init(&v_full[s], 1);
      hw::mbar_init(&empty[s], 128 * TC_WGS);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == TC_WGS) {
    // ---------------- producer warp: one thread issues every TMA load
    if (tid == 128 * TC_WGS) {
      hw::mbar_arrive_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < T::NCB; ++c)
        hw::tma_load_4d(Qs + c * T::Q_BLOCK, &tm_q, q_full, c * T::CE, h, q_start, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % TC_STAGES;
        if (j >= TC_STAGES) hw::mbar_wait(&empty[s], (j / TC_STAGES - 1) & 1);
        const int k0 = k_begin + j * TC_BK;
        hw::mbar_arrive_expect_tx(&k_full[s], T::KV_BYTES);
        for (int c = 0; c < T::NCB; ++c)
          hw::tma_load_4d(Ks + s * T::KV_BYTES + c * T::KV_BLOCK, &tm_k, &k_full[s],
                          c * T::CE, kvh, k0, b);
        hw::mbar_arrive_expect_tx(&v_full[s], T::KV_BYTES);
        for (int c = 0; c < T::NCB; ++c)
          hw::tma_load_4d(Vs + s * T::KV_BYTES + c * T::KV_BLOCK, &tm_v, &v_full[s],
                          c * T::CE, kvh, k0, b);
      }
    }
    return;
  }

  // ---------------- consumer warpgroup wg: q rows wq0 .. wq0+63
  const int wq0 = q_start + 64 * wg;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int r_lo = wq0 + 16 * ((tid & 127) >> 5) + (lane >> 2);  // rows r_lo, r_lo + 8
#if FLASH_CAUSAL
  const int k_end_w = min(len_b, min(wq0 + 64, Sq));
#else
  const int k_end_w = len_b;
#endif

  // q rows of this warpgroup: scale (D^-0.5 by default) and round to bf16, in place
  // (the swizzle permutes 16-byte chunks within a row, so any elementwise
  // pass over the rows' bytes is layout-free)
  hw::mbar_wait(q_full, 0);
#pragma unroll
  for (int c = 0; c < T::NCB; ++c) {
    uint4* rows = reinterpret_cast<uint4*>(Qs + c * T::Q_BLOCK + 64 * wg * T::SW);
    for (int i = tid & 127; i < 64 * T::SW / 16; i += 128) {
      uint4 w = rows[i];
      uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&u[e]);
        u[e] = pack_bf16(__bfloat162float(x.x) * scale, __bfloat162float(x.y) * scale);
      }
      rows[i] = w;
    }
  }
  hw::fence_proxy_async();
  hw::named_barrier(1 + wg, 128);

  const uint32_t q_addr = hw::smem_addr(Qs) + 64 * wg * T::SW;
  const uint32_t k_addr = hw::smem_addr(Ks);
  const uint32_t v_addr = hw::smem_addr(Vs);

  constexpr int DP = T::DP;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % TC_STAGES;
    const uint32_t parity = (j / TC_STAGES) & 1;
    const int k0 = k_begin + j * TC_BK;
    hw::mbar_wait(&k_full[s], parity);
    const bool skip = k0 >= k_end_w || (window > 0 && k0 + TC_BK - 1 <= wq0 - window);
    if (!skip) {
      // S = Q K^T over DP, 16 at a time
      float sc[TC_BK / 2];
#pragma unroll
      for (int i = 0; i < TC_BK / 2; ++i) sc[i] = 0.f;
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int cb = kk * 16 / T::CE;                   // column block
        const uint32_t off = ((kk * 16) % T::CE) * 2;      // bytes into its rows
        const uint64_t da = hw::make_desc(q_addr + cb * T::Q_BLOCK + off, 16, 8 * T::SW, T::SW);
        const uint64_t db = hw::make_desc(k_addr + s * T::KV_BYTES + cb * T::KV_BLOCK + off,
                                          16, 8 * T::SW, T::SW);
        hw::wgmma_m64n128k16_ss(sc, da, db, kk > 0);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(sc);

      // sc[4i + t]: row r_lo + 8*(t >> 1), key k0 + 8i + 2*quad + (t & 1)
#if FLASH_CAUSAL
      const bool need_mask = k0 + TC_BK - 1 > wq0 || k0 + TC_BK > len_b ||
                             (window > 0 && k0 <= wq0 + 63 - window);
#else
      const bool need_mask = k0 + TC_BK > len_b || (window > 0 && k0 <= wq0 + 63 - window);
#endif
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < TC_BK / 8; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int key = k0 + 8 * i + 2 * quad + (t & 1);
            const int row = r_lo + 8 * (t >> 1);
#if FLASH_CAUSAL
            const bool valid = key < len_b && key <= row && (window <= 0 || key > row - window);
#else
            const bool valid = key < len_b && (window <= 0 || key > row - window);
#endif
            if (!valid) sc[4 * i + t] = NEG_INF;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < TC_BK / 8; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) mx[t >> 1] = fmaxf(mx[t >> 1], sc[4 * i + t]);
      float alpha[2], ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
        ms[r] = mx[r] * LOG2E;
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < TC_BK / 8; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float x = sc[4 * i + t];
          const float p = (need_mask && x == NEG_INF) ? 0.f : exp2f(fmaf(x, LOG2E, -ms[t >> 1]));
          sc[4 * i + t] = p;
          rs[t >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int i = 0; i < DP / 8; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) o[4 * i + t] *= alpha[t >> 1];

      // P as the register A operand: the accumulator layout of keys
      // 16kk..16kk+15 is the A fragment of k-step kk
      uint32_t pa[TC_BK / 4];
#pragma unroll
      for (int i = 0; i < TC_BK / 8; ++i) {
        pa[2 * i] = pack_bf16(sc[4 * i], sc[4 * i + 1]);
        pa[2 * i + 1] = pack_bf16(sc[4 * i + 2], sc[4 * i + 3]);
      }

      // O += P V over the tile's keys, 16 at a time
      hw::mbar_wait(&v_full[s], parity);
      hw::fence_regs(o);
      hw::fence_regs(pa);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        const uint64_t db = hw::make_desc(v_addr + s * T::KV_BYTES + kk * 16 * T::SW,
                                          T::KV_BLOCK, 8 * T::SW, T::SW);
        hw::WgmmaRS<DP>::run(o, a, db, 1);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(o);
    } else {
      hw::mbar_wait(&v_full[s], parity);
    }
    hw::mbar_arrive(&empty[s]);
  }

  // o[4i + t]: row r_lo + 8*(t >> 1), column 8i + 2*quad + (t & 1); the
  // columns past D (i >= D/8) are the pad's
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* dst = out + (((size_t)b * Sq + row) * H + h) * D + 2 * quad;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(dst + 8 * i) =
          pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* lens,
                         void* out, int B, int Sq, int Skv, int H, int KV, int window,
                         float scale, cudaStream_t stream) {
  using T = TcTile<D>;
  static bool attr_set = false;  // the opt-in above 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  cudaError_t e = hw::make_tmap_bf16_4d(&tq, q, D, H, Sq, B, T::CE, TC_BQ, T::SW);
  if (e == cudaSuccess) e = hw::make_tmap_bf16_4d(&tk, k, D, KV, Skv, B, T::CE, TC_BK, T::SW);
  if (e == cudaSuccess) e = hw::make_tmap_bf16_4d(&tv, v, D, KV, Skv, B, T::CE, TC_BK, T::SW);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  flash_fwd_wgmma<D><<<grid, TC_THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), Sq, Skv,
      H, KV, window, scale);
  return cudaGetLastError();
}

template <bool BF16, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lens, void* out,
                   int B, int Sq, int Skv, int H, int KV, int window, float scale,
                   cudaStream_t stream) {
  if constexpr (BF16)
    return launch_wgmma<D>(q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, stream);
  else
    return launch_simt<D>(q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, stream);
}

template <bool BF16>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* lens, void* out, int B, int Sq, int Skv,
                       int H, int KV, int window, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<BF16, 32>(q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, stream);
    case 64: return launch<BF16, 64>(q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, stream);
    case 80: return launch<BF16, 80>(q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, stream);
    case 112: return launch<BF16, 112>(q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, stream);
    case 120: return launch<BF16, 120>(q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, stream);
    case 128: return launch<BF16, 128>(q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32 (SIMT kernel), 1 = bf16 (wgmma kernel; q, k, v 16-byte
// aligned). Returns cudaGetLastError() after the launch.
extern "C" int FLASH_ENTRY(const void* q, const void* k, const void* v, const void* lens,
                           void* out, int B, int Sq, int Skv, int H, int KV, int D,
                           int window, float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<false>(D, q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, s);
  if (dtype == 1) {
    if (Skv == 0)  // no key: every row writes 0 (a tensor map needs a non-empty extent)
      return cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * 2, s);
    return dispatch_d<true>(D, q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, s);
  }
  return cudaErrorInvalidValue;
}
