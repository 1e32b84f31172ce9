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
// One block of four warps per (64-row q tile, q head, batch row). Thread t
// owns q rows rg + 8i (i < 8, row group rg = t / 16); in S = Q K^T it
// computes keys kl + 16j (j < 4, lane kl = t % 16) of each 64-key tile, in
// O += P V the columns of its lane (SimtTile::NC of them). A row group's 16
// lanes are half a warp, so a row's max and sum are shuffles.
constexpr int SM_BQ = 64;         // q rows per block
constexpr int SM_BK = 64;         // keys per k/v tile
constexpr int SM_THREADS = 128;   // 8 row groups x 16 lanes
constexpr int SM_CE = 32;         // fp32 columns of one 128-byte swizzle row

// Shared-memory geometry of one head dim. q and k are NCB column blocks of
// 64 rows x 32 fp32, each row 128 bytes in TMA's 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8); columns past D zero-filled); v is
// 64 dense rows of DP fp32, D rounded up to 16 (the pad zero-filled); P is
// 64 keys x 64 rows, row rg + 8i at column 8 rg + i, chunk c of key r at
// chunk c ^ 2 (r % 4).
template <int D>
struct SimtTile {
  static constexpr int NCB = (D + SM_CE - 1) / SM_CE;
  static constexpr int BLOCK = SM_BQ * SM_CE * 4;   // bytes of a q or k column block
  static constexpr int QK_BYTES = NCB * BLOCK;      // a q or k tile
  static constexpr int DP = (D + 15) / 16 * 16;
  static constexpr int V_BYTES = SM_BK * DP * 4;
  static constexpr int P_BYTES = SM_BK * SM_BQ * 4;
  static constexpr int DATA = 2 * QK_BYTES + V_BYTES + P_BYTES;
  // 1024 bytes of slack to align q and k to the swizzle pattern's period
  // (115,712 bytes at D 128: two blocks an SM); the three mbarriers take
  // 32 bytes of the slack, or follow the data where the slack is smaller
  static constexpr size_t SMEM = DATA + 1024;
  // a lane's output columns, in pieces of 4 (64 apart), then 2, then 1
  static constexpr int NC = DP / 16;
  static constexpr int N4 = NC / 4;
  static constexpr int N2 = NC % 4 / 2;
  static constexpr int N1 = NC % 2;
};
static_assert(SM_BQ == SM_BK, "q and k tiles share their column blocks' geometry");

// S += Q K^T over one chunk of 4 columns: the thread's q rows at q + 1024 i,
// its keys at k + 2048 j (each address already swizzled).
__device__ __forceinline__ void qk_chunk(float (&s)[8][4], const uint8_t* q, const uint8_t* k) {
  float4 kv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(k + 2048 * j);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 qv = *reinterpret_cast<const float4*>(q + 1024 * i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
      s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
      s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
      s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
    }
  }
}

// Lane kl's columns of one v row.
template <int D>
__device__ __forceinline__ void load_v(float (&v)[SimtTile<D>::NC], const float* row, int kl) {
  using T = SimtTile<D>;
#pragma unroll
  for (int p = 0; p < T::N4; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(row + 64 * p + 4 * kl);
    v[4 * p] = x.x;
    v[4 * p + 1] = x.y;
    v[4 * p + 2] = x.z;
    v[4 * p + 3] = x.w;
  }
  if constexpr (T::N2 != 0) {
    const float2 x = *reinterpret_cast<const float2*>(row + 64 * T::N4 + 2 * kl);
    v[4 * T::N4] = x.x;
    v[4 * T::N4 + 1] = x.y;
  }
  if constexpr (T::N1 != 0) v[4 * T::N4 + 2 * T::N2] = row[64 * T::N4 + 32 * T::N2 + kl];
}

template <int D>
__global__ void __launch_bounds__(SM_THREADS, 2)
flash_fwd_simt(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ lens,
               float* __restrict__ out, int Sq, int Skv, int H, int KV, int window,
               float scale) {
  using T = SimtTile<D>;
  constexpr int NC = T::NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t slack = (1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023;
  uint8_t* Qs = smem_raw + slack;
  uint8_t* Ks = Qs + T::QK_BYTES;
  float* Vs = reinterpret_cast<float*>(Ks + T::QK_BYTES);
  float* Ps = reinterpret_cast<float*>(Ks + T::QK_BYTES + T::V_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(slack >= 32 ? smem_raw : Qs + T::DATA);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 2;

  const int tid = threadIdx.x;
  const int kl = tid & 15;
  const int rg = tid >> 4;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * SM_BQ;  // the heaviest q tiles first
  const int kvh = h / (H / KV);
  const int len_b = min(lens[b], Skv);
#if FLASH_CAUSAL
  const int k_end = min(len_b, min(q0 + SM_BQ, Sq));  // causal: no key past the last row
#else
  const int k_end = len_b;
#endif
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / SM_BK) * SM_BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + SM_BK - 1) / SM_BK : 0;

  float acc[8][NC], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  if (n_tiles > 0) {  // else every row writes 0
    if (tid == 0) {
      hw::mbar_init(q_full, 1);
      hw::mbar_init(k_full, 1);
      hw::mbar_init(v_full, 1);
      hw::mbar_fence_init();
      hw::mbar_arrive_expect_tx(q_full, T::QK_BYTES);
      for (int c = 0; c < T::NCB; ++c)
        hw::tma_load_4d(Qs + c * T::BLOCK, &tm_q, q_full, c * SM_CE, h, q0, b);
      hw::mbar_arrive_expect_tx(k_full, T::QK_BYTES);
      for (int c = 0; c < T::NCB; ++c)
        hw::tma_load_4d(Ks + c * T::BLOCK, &tm_k, k_full, c * SM_CE, kvh, k_begin, b);
      hw::mbar_arrive_expect_tx(v_full, T::V_BYTES);
      hw::tma_load_4d(Vs, &tm_v, v_full, 0, kvh, k_begin, b);
    }
    __syncthreads();  // the barriers are initialised

    // scale the q tile in place, once (an elementwise pass: layout-free)
    hw::mbar_wait(q_full, 0);
    for (int i = tid; i < T::QK_BYTES / 16; i += SM_THREADS) {
      float4* x = reinterpret_cast<float4*>(Qs) + i;
      const float4 y = *x;
      *x = make_float4(y.x * scale, y.y * scale, y.z * scale, y.w * scale);
    }
    __syncthreads();

    // row rg of a q column block and key row kl of a k column block, each
    // with its swizzle phase in bits 4-6: chunk c is at off ^ (c << 4)
    const int q_off = rg * 128 + (rg << 4);
    const int k_off = kl * 128 + ((kl & 7) << 4);
    // P: the thread's rows at chunks 2 rg, 2 rg + 1 of its keys' rows
    float* p_write = Ps + ((2 * rg) ^ (2 * (kl & 3))) * 4 + kl * SM_BQ;

    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = k_begin + j * SM_BK;
      const uint32_t parity = j & 1;
      hw::mbar_wait(k_full, parity);

      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 1
      for (int cb = 0; cb < D / SM_CE; ++cb) {
        const uint8_t* qb = Qs + cb * T::BLOCK;
        const uint8_t* kb = Ks + cb * T::BLOCK;
#pragma unroll
        for (int c = 0; c < 8; ++c) qk_chunk(s, qb + (q_off ^ (c << 4)), kb + (k_off ^ (c << 4)));
      }
      if constexpr (D % SM_CE != 0) {  // the last column block's D % 32 columns
        const uint8_t* qb = Qs + (D / SM_CE) * T::BLOCK;
        const uint8_t* kb = Ks + (D / SM_CE) * T::BLOCK;
#pragma unroll
        for (int c = 0; c < D % SM_CE / 4; ++c)
          qk_chunk(s, qb + (q_off ^ (c << 4)), kb + (k_off ^ (c << 4)));
      }

      // online softmax; s[i][jj]: row q0 + rg + 8i, key k0 + kl + 16jj
#if FLASH_CAUSAL
      const bool need_mask = k0 + SM_BK - 1 > q0 || k0 + SM_BK > len_b ||
                             (window > 0 && k0 <= q0 + SM_BQ - 1 - window);
#else
      const bool need_mask = k0 + SM_BK > len_b || (window > 0 && k0 <= q0 + SM_BQ - 1 - window);
#endif
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int row = q0 + rg + 8 * i;
            const int key = k0 + kl + 16 * jj;
#if FLASH_CAUSAL
            const bool valid = key < len_b && key <= row && (window <= 0 || key > row - window);
#else
            const bool valid = key < len_b && (window <= 0 || key > row - window);
#endif
            if (!valid) s[i][jj] = NEG_INF;
          }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float p = (need_mask && s[i][jj] == NEG_INF) ? 0.f : expf(s[i][jj] - m_new);
          s[i][jj] = p;
          rs += p;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l[i] = l[i] * alpha + rs;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float* pk = p_write + 16 * jj * SM_BQ;
        *reinterpret_cast<float4*>(pk) = make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
        *reinterpret_cast<float4*>(pk + 4) = make_float4(s[4][jj], s[5][jj], s[6][jj], s[7][jj]);
      }
      __syncthreads();  // P is written; every thread is done with the k tile
      if (tid == 0 && j + 1 < n_tiles) {
        hw::mbar_arrive_expect_tx(k_full, T::QK_BYTES);
        for (int c = 0; c < T::NCB; ++c)
          hw::tma_load_4d(Ks + c * T::BLOCK, &tm_k, k_full, c * SM_CE, kvh, k0 + SM_BK, b);
      }

      // O += P V over the tile's keys, 8 at a time, up to the last that
      // counts for any row of the block
      hw::mbar_wait(v_full, parity);
      const int n8 = min(SM_BK / 8, (k_end - k0 + 7) / 8);
#pragma unroll 1
      for (int g = 0; g < n8; ++g) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int key = 8 * g + u;
          const float* pk = Ps + key * SM_BQ + ((2 * rg) ^ (2 * (u & 3))) * 4;
          const float4 pa = *reinterpret_cast<const float4*>(pk);
          const float4 pb = *reinterpret_cast<const float4*>(pk + 4);
          const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
          float v[NC];
          load_v<D>(v, Vs + key * T::DP, kl);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], v[c], acc[i][c]);
        }
      }
      __syncthreads();  // every thread is done with P and the v tile
      if (tid == 0 && j + 1 < n_tiles) {
        hw::mbar_arrive_expect_tx(v_full, T::V_BYTES);
        hw::tma_load_4d(Vs, &tm_v, v_full, 0, kvh, k0 + SM_BK, b);
      }
    }
  }

  // the lane's columns of rows q0 + rg + 8i; those past D (D 120's pad) unstored
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + rg + 8 * i;
    if (row >= Sq) continue;
    float o[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c] = l[i] > 0.f ? acc[i][c] / l[i] : 0.f;
    float* dst = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int p = 0; p < T::N4; ++p)
      if (64 * p + 4 * kl < D)
        *reinterpret_cast<float4*>(dst + 64 * p + 4 * kl) =
            make_float4(o[4 * p], o[4 * p + 1], o[4 * p + 2], o[4 * p + 3]);
    if constexpr (T::N2 != 0)
      *reinterpret_cast<float2*>(dst + 64 * T::N4 + 2 * kl) =
          make_float2(o[4 * T::N4], o[4 * T::N4 + 1]);
    if constexpr (T::N1 != 0) dst[64 * T::N4 + 32 * T::N2 + kl] = o[4 * T::N4 + 2 * T::N2];
  }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* lens,
                        void* out, int B, int Sq, int Skv, int H, int KV, int window,
                        float scale, cudaStream_t stream) {
  using T = SimtTile<D>;
  static bool attr_set = false;  // the opt-in above 48 KB and the carveout, once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_simt<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_simt<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  // fp32 rows of D x 4 bytes (128-512: multiples of 16); q and k in 32-column
  // boxes of 64 rows under the 128-byte swizzle, v in one dense box of DP
  const uint64_t dq[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)Sq, (uint64_t)B};
  const uint64_t dk[4] = {(uint64_t)D, (uint64_t)KV, (uint64_t)Skv, (uint64_t)B};
  const uint64_t sq[3] = {dq[0] * 4, dq[0] * dq[1] * 4, dq[0] * dq[1] * dq[2] * 4};
  const uint64_t sk[3] = {dk[0] * 4, dk[0] * dk[1] * 4, dk[0] * dk[1] * dk[2] * 4};
  const uint32_t box_qk[4] = {SM_CE, 1, SM_BQ, 1};
  const uint32_t box_v[4] = {T::DP, 1, SM_BK, 1};
  CUtensorMap tq, tk, tv;
  cudaError_t e = hw::make_tmap_4d(&tq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, q, dq, sq, box_qk, 128);
  if (e == cudaSuccess)
    e = hw::make_tmap_4d(&tk, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, k, dk, sk, box_qk, 128);
  if (e == cudaSuccess)
    e = hw::make_tmap_4d(&tv, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, v, dk, sk, box_v, 0);
  if (e != cudaSuccess) return e;
  const dim3 grid(H * B, (Sq + SM_BQ - 1) / SM_BQ);
  flash_fwd_simt<D><<<grid, SM_THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<const int*>(lens), static_cast<float*>(out), Sq, Skv, H, KV,
      window, scale);
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

// dtype: 0 = fp32 (SIMT kernel), 1 = bf16 (wgmma kernel); both read q, k
// and v through TMA, so their bases are 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int FLASH_ENTRY(const void* q, const void* k, const void* v, const void* lens,
                           void* out, int B, int Sq, int Skv, int H, int KV, int D,
                           int window, float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Skv == 0)  // no key: every row writes 0 (a tensor map needs a non-empty extent)
    return cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * (dtype == 0 ? 4 : 2), s);
  if (dtype == 0)
    return dispatch_d<false>(D, q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, s);
  return dispatch_d<true>(D, q, k, v, lens, out, B, Sq, Skv, H, KV, window, scale, s);
}
