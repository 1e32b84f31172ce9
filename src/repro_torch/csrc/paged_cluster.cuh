// K2's default mode over pages of another dtype than q (the reference
// model's decode_attention, src/repro/models/attention.py:102-124: q*scale
// rounded to the pages' dtype, the normalised weights exp(s - M) / L
// rounded to it, fp32 sums, out in q's dtype) as one launch that reads each
// counted key's k and v once. Included by paged_attention_cvt.cu, beside the
// two-pass kernels of paged_cvt.cuh, which keep the sequences whose scores
// do not fit this design's shared memory.
//
// Replaces: the Pallas TPU kernel paged_attention_kernel (body
// _paged_kernel, src/repro/kernels/paged_attention/kernel.py:79) for pages
// of fp8 e4m3 or int8 under a bf16 or fp32 q, and bf16 pages under an fp32
// q (paged_cvt.cuh's header says why the port computes decode_attention's
// function and not the Pallas kernel's).
//
// Bound on this card: HBM bytes, each counted key's k and v row read once
// at the pages' width. The weights need each row's global (M, L) before
// p.v, which the two-pass design gets by reading k twice over four
// launches. Design:
// - One thread block cluster of C <= 8 blocks (the portable limit) per
//   (batch row, kv head); each block takes a contiguous C-th of the
//   sequence's pages in its window, and its four warps take the block's
//   pages in turn. A block's work is a chain of latencies (the pages'
//   copies, the cluster's barriers), so the launch picks C by occupancy:
//   the largest that needs the fewest waves of clusters (launch_cluster).
// - Whole pages come by TMA: a 4-d tensor map over the pool (P, 16, KV, D),
//   a box of one page's 16 token rows of one kv head, 128 bytes a row
//   (8-bit: D <= 128 elements, columns past D zero-filled; bf16: two boxes
//   of 64), 128-byte swizzled. 8-bit rows of D 120 are not 16-byte strided:
//   they take a map over (KV*D, 16, P) whose box starts at the 16-byte
//   boundary at or before the head's row (TMA takes no other start there),
//   so an odd head's row lies 8 bytes into the box and is read as two
//   8-byte halves of neighbouring chunks; the bytes of other heads are
//   masked. Each warp keeps a ring of RING pages on mbarriers, k's
//   pages first and then v's, so v's first pages are in flight before the
//   cluster barrier.
// - Each block computes its scores from k with mma.sync (m16n8k16, fp32
//   sums) and keeps them in shared memory as fp32 (pages x G query rows x
//   16 tokens x 4 B: 6 KB a block for llama3.2-3b's longest sequence at
//   C 8; the padded rows of the mma's n tile are not kept), with each
//   warp's running (m, l).
// - The blocks exchange their (m, l) through distributed shared memory
//   (mapa, ld.shared::cluster, the cluster barrier): every block merges
//   them in the same order into the row's (M, L).
// - Each block forms the rounded weights from its stored scores and runs
//   p.v over its v pages; the blocks' fp32 sums are added through
//   distributed shared memory, each block writing a C-th of the output once.
// - exp is ex2.approx (fast_exp) and the weights' division by L a product
//   by 1/L: each within a few ulps of the plain version's, so a weight
//   flips to the other neighbour of the pages' dtype only within
//   weight_slack's 2^-12 of a boundary.
// - Conversions: every e4m3 and int8 value, q*scale and the weights rounded
//   to them, is exact in f16, so the products run on the f16 tensor cores;
//   an e4m3 pair takes one cvt.rn.f16x2.e4m3x2, an int8 pair a byte permute
//   and one f16x2 subtraction (0x64XX is 1024 + XX). bf16 pages run the
//   bf16 tensor cores on their own bits. Each element is converted once, in
//   registers: k rows as 16-byte loads (the mma's k slots permuted to the
//   thread's bytes, q's fragments permuted alike), v as 4-byte loads of two
//   tokens' rows, interleaved by byte permutes into the A operand of
//   V^T P^T.
// - The scores' shared memory is SCORE_BYTES at most: a sequence past it
//   (at C 8 more than 8 * floor(SCORE_BYTES / (64 G)) pages in one window:
//   65,536 tokens at G 3, 12,288 at G 16) takes the two-pass kernels
//   (kernels/paged_attention/ops.py cvt_design).
#pragma once

#include <cuda_fp16.h>

#include "paged_cvt.cuh"

namespace paged_cluster {

using namespace repro_torch;
using namespace repro_torch::paged;
using paged_cvt::E4M3;
using paged_cvt::round_to;
namespace hw = repro_torch::hopper;

constexpr int CLUSTER = 8;               // most blocks of a cluster
constexpr int CW = 4;                    // warps of a block
constexpr int RING = 2;                  // pages in flight per warp
constexpr int DPC = 128;                 // head-dim geometry
constexpr int ROW = 128;                 // bytes of a token row in a box
constexpr int BOX_BYTES = PAGE * ROW;    // one TMA box
constexpr int SCORE_BYTES = 96 * 1024;   // the scores' shared memory, most

// The pages' element type: bytes an element, 128-byte boxes a row, bytes
// of one page of one kv head, 16-byte chunks of a row a thread reads, d
// pairs a chunk holds.
template <typename TK>
struct Pages {
  static constexpr int EB = (int)sizeof(TK);
  static constexpr int NBOX = DPC * EB / ROW;
  static constexpr int BYTES = NBOX * BOX_BYTES;
  static constexpr int CHUNKS = NBOX * 2;
  static constexpr int PER_CHUNK = 8 / EB;
  static constexpr int SPAN = 32 / EB;        // head dims of a v group: 8 threads x a word
  static constexpr int TILES = SPAN / 16;     // m tiles of a v group
};

template <int NT, typename TK>
__host__ __device__ constexpr int region_bytes() {  // the rings, later the warps' fp32 sums
  return CW * RING * Pages<TK>::BYTES > CW * NTILE * NT * DPC * 4
             ? CW * RING * Pages<TK>::BYTES
             : CW * NTILE * NT * DPC * 4;
}

// The head dim of pair i (two consecutive dims) of a k row held by the
// thread of column tig: chunk i / PER_CHUNK of the thread's, tig + 4j of
// the row's.
template <typename TK>
__device__ __forceinline__ int dpair(int tig, int i) {
  using PG = Pages<TK>;
  return (tig + 4 * (i / PG::PER_CHUNK)) * (16 / PG::EB) + 2 * (i % PG::PER_CHUNK);
}

__device__ __forceinline__ uint32_t word_of(const uint4& u, int c) {
  return c == 0 ? u.x : c == 1 ? u.y : c == 2 ? u.z : u.w;
}

// Two consecutive elements of `word` (bytes 2*half and 2*half + 1; a bf16
// word is one pair) as the mma's operand pair: f16x2 for 8-bit pages.
template <typename TK> __device__ __forceinline__ uint32_t op_pair(uint32_t word, int half);
template <> __device__ __forceinline__ uint32_t op_pair<E4M3>(uint32_t word, int half) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>((word >> (16 * half)) & 0xffffu), __NV_E4M3);
  return (uint32_t)h.x | ((uint32_t)h.y << 16);
}
template <> __device__ __forceinline__ uint32_t op_pair<int8_t>(uint32_t word, int half) {
  // f16 0x64XX is 1024 + XX: each byte, its sign bit flipped, is b + 128
  const uint32_t t = __byte_perm(word ^ 0x80808080u, 0x64646464u, half ? 0x4342 : 0x4140);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&t),
                            __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480)));
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t op_pair<__nv_bfloat16>(uint32_t word, int) {
  return word;
}

// Pair i of a k row held in the thread's chunks.
template <typename TK, int CH>
__device__ __forceinline__ uint32_t k_pair(const uint4 (&c)[CH], int i) {
  using PG = Pages<TK>;
  const int p = i % PG::PER_CHUNK;
  if constexpr (PG::EB == 1) return op_pair<TK>(word_of(c[i / PG::PER_CHUNK], p / 2), p % 2);
  else return word_of(c[i / PG::PER_CHUNK], p);
}

// Two weights in [0, 1] (or NaN) rounded to the pages' dtype as
// round_to<TK> rounds them, as the operand pair: e4m3 by one cvt to e4m3x2
// and one back to f16x2 (NaN stays NaN; past 464 cannot occur); int8
// truncated, so 1 where a weight is 1 and 0 below it or for NaN; bf16.
template <typename TK> __device__ __forceinline__ uint32_t weights_op(float a, float b);
template <> __device__ __forceinline__ uint32_t weights_op<E4M3>(float a, float b) {
  const __nv_fp8x2_storage_t r = __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE,
                                                          __NV_E4M3);
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(r, __NV_E4M3);
  return (uint32_t)h.x | ((uint32_t)h.y << 16);
}
template <> __device__ __forceinline__ uint32_t weights_op<int8_t>(float a, float b) {
  return (a >= 1.f ? 0x3c00u : 0u) | (b >= 1.f ? 0x3c000000u : 0u);   // f16 1.0
}
template <> __device__ __forceinline__ uint32_t weights_op<__nv_bfloat16>(float a, float b) {
  return paged_cvt::pack_bf16(a, b);
}

// exp(x) as ex2.approx of x * log2(e): within 2^-21 of it for the
// arguments here (|x| below about 100, else 0), which weight_slack's
// 2^-12 covers; exp(0) is exactly 1, so int8's one edge keeps its side.
__device__ __forceinline__ float fast_exp(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

template <typename TK> __device__ __forceinline__ uint16_t op_bits(float x) {
  if constexpr (Pages<TK>::EB == 1) return __half_as_ushort(__float2half_rn(x));
  else return __bfloat16_as_ushort(__float2bfloat16(x));
}

template <typename TK>
__device__ __forceinline__ void mma_op(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  if constexpr (Pages<TK>::EB == 1) hw::mma_16816_f16(d, a, b);
  else hw::mma_16816(d, a, b);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// One cluster per (batch row, kv head) (the grid (C, KV, B), cluster dims
// (C, 1, 1)). q and out (B, KV, G, D) of TQ; the pages through tk and tv
// (flat: the (KV*D, 1, 16, P) map, its box at the 16-byte boundary at or
// before head kvh's row, kvh*D bytes); pmax the most
// pages a block takes, which sizes its scores. NT n tiles of 8 queries.
template <typename TK, typename TQ, int NT>
__global__ void __launch_bounds__(CW * 32)
paged_cluster_cvt(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const TQ* __restrict__ q, const int* __restrict__ tables,
                  const int* __restrict__ lens, TQ* __restrict__ out, int KV, int G, int D,
                  int max_blocks, int window, float scale, int flat, int pmax) {
  using PG = Pages<TK>;
  constexpr int GM = NTILE * NT;   // query rows, padded
  constexpr int KS = DPC / 16;     // k steps of q.k, m tiles of p.v
  constexpr int REGION = region_bytes<NT, TK>();
  __shared__ __align__(16) uint16_t qs[GM][DPC];
  __shared__ float2 mlw[CW][GM];
  __shared__ float2 mlb[GM];       // the block's (m, l), read by the cluster
  __shared__ float Ms[GM], Ls[GM];
  __shared__ __align__(8) uint64_t full[CW][RING];
  extern __shared__ uint8_t dsmem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dsmem) + 1023) & ~static_cast<uintptr_t>(1023));
  float* scores = reinterpret_cast<float*>(base + REGION);   // [pmax][G][PAGE]

  const int C = gridDim.x;
  const uint32_t rank = hw::cluster_ctarank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // the block's pages: a C-th of the sequence's in its window
  const int len = lens[b];
  const int lo = window_start(len, window);
  const int p_lo = lo / PAGE;
  const int n = max(0, pages_used(len, max_blocks) - p_lo);
  const int per = (n + C - 1) / C;
  if (per > pmax) __trap();   // the host sized the scores for pmax pages
  const int begin = p_lo + (int)rank * per;
  const int n_b = max(0, min(per, n - (int)rank * per));
  const int n_w = n_b > warp ? (n_b - warp + CW - 1) / CW : 0;   // this warp's pages
  const int items = 2 * n_w;                                      // k's, then v's
  uint8_t* ring = base + warp * RING * PG::BYTES;
  const int nbox = (D * PG::EB + ROW - 1) / ROW;                  // boxes a row fills
  const int shift = flat ? (kvh * D) & 15 : 0;   // the row's bytes into its box: 0 or 8

  int pid[2];   // the page ids of the warp's pages lane and lane + 32 (later ones: read at issue)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = lane + 32 * h;
    pid[h] = x < n_w ? tables[(size_t)b * max_blocks + begin + warp + CW * x] : 0;
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < RING; ++s) hw::mbar_init(&full[warp][s], 1);
    hw::mbar_fence_init();
  }
  // the boxes no copy writes (bf16 pages of D <= 64) read as zeros
  if (nbox < PG::NBOX)
    for (int i = lane * 16; i < RING * PG::BYTES; i += 32 * 16)
      if (i % PG::BYTES >= nbox * BOX_BYTES)
        *reinterpret_cast<uint4*>(ring + i) = make_uint4(0, 0, 0, 0);
  __syncwarp();
  // item it (k's page it, or v's page it - n_w) into its ring slot; every
  // lane calls it, lane 0 issues
  const CUtensorMap* maps[2] = {&tk, &tv};
  auto issue = [&](int it) {
    const bool is_v = it >= n_w;
    const int x = is_v ? it - n_w : it;
    const int page = x < 64 ? __shfl_sync(0xffffffffu, x < 32 ? pid[0] : pid[1], x & 31)
                            : tables[(size_t)b * max_blocks + begin + warp + CW * x];
    if (lane == 0) {
      uint8_t* dst = ring + (it % RING) * PG::BYTES;
      uint64_t* bar = &full[warp][it % RING];
      hw::fence_proxy_async();   // the slot's earlier reads before the copy's writes
      hw::mbar_arrive_expect_tx(bar, nbox * BOX_BYTES);
      for (int x2 = 0; x2 < nbox; ++x2)
        hw::tma_load_4d(dst + x2 * BOX_BYTES, maps[is_v], bar,
                        (flat ? kvh * D - shift : 0) + x2 * (ROW / PG::EB), flat ? 0 : kvh, 0,
                        page);
    }
  };
  for (int it = 0; it < RING && it < items; ++it) issue(it);

  // q*scale rounded to the pages' dtype, in the operand type; query rows
  // G..GM-1 and head dims D..DPC-1 are zeros
  for (int i = tid; i < GM * DPC; i += CW * 32) {
    const int g = i / DPC, d = i % DPC;
    float x = 0.f;
    if (g < G && d < D) x = round_to<TK>(to_f(q[(((size_t)b * KV + kvh) * G + g) * D + d]) * scale);
    qs[g][d] = op_bits<TK>(x);
  }
  __syncthreads();
  // q^T as the B operand of K Q^T: k slots 2tig, 2tig+1 of step s are the
  // thread's pair 2s, slots 2tig+8, 2tig+9 its pair 2s+1
  uint32_t qb[NT][KS][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const uint16_t* row = qs[NTILE * nt + gid];
      qb[nt][s][0] = *reinterpret_cast<const uint32_t*>(row + dpair<TK>(tig, 2 * s));
      qb[nt][s][1] = *reinterpret_cast<const uint32_t*>(row + dpair<TK>(tig, 2 * s + 1));
    }

  // ---- k: scores into shared memory, the warp's running (m, l)
  // the mma's row gid is token rl (gid's bits rotated: the two rows of a
  // quarter warp lie 4 rows apart, so their swizzled chunks never collide)
  const int rl = (gid >> 1) | ((gid & 1) << 2);
  float m[NT][2], l[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[nt][e] = NEG_INF;
      l[nt][e] = 0.f;
    }
  for (int it = 0; it < n_w; ++it) {
    const int slot = it % RING;
    hw::mbar_wait(&full[warp][slot], (it / RING) & 1);
    const int k = warp + CW * it, j = begin + k;
    const int n_valid = min(PAGE, len + 1 - j * PAGE);   // tokens in the sequence
    const int n_skip = max(0, lo - j * PAGE);            // tokens left of the window
    const uint8_t* pg = ring + slot * PG::BYTES;
    uint4 kr[2][PG::CHUNKS];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < PG::CHUNKS; ++c) {
        const int L = tig + 4 * c;
        const uint8_t* row = pg + (L >> 3) * BOX_BYTES + (rl + 8 * r) * ROW;
        if (shift == 0) {
          kr[r][c] = *reinterpret_cast<const uint4*>(row + (((L & 7) ^ rl) << 4));
        } else {   // the chunk's halves: the end of box chunk L, the start of L + 1
          const uint2 lo = *reinterpret_cast<const uint2*>(row + (((L & 7) ^ rl) << 4) + 8);
          const uint2 hi = (L & 7) < 7
                               ? *reinterpret_cast<const uint2*>(row + ((((L & 7) + 1) ^ rl) << 4))
                               : make_uint2(0, 0);
          kr[r][c] = make_uint4(lo.x, lo.y, hi.x, hi.y);
        }
        if (flat) {   // the next head's bytes past D (4-byte words; D is a multiple of 8)
          const int d0 = L * 16 / PG::EB;   // the chunk's first head dim
          if (d0 + 4 / PG::EB > D) kr[r][c].x = 0;
          if (d0 + 8 / PG::EB > D) kr[r][c].y = 0;
          if (d0 + 12 / PG::EB > D) kr[r][c].z = 0;
          if (d0 + 16 / PG::EB > D) kr[r][c].w = 0;
        }
      }
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nt][r] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const uint32_t a[4] = {k_pair<TK>(kr[0], 2 * s), k_pair<TK>(kr[1], 2 * s),
                             k_pair<TK>(kr[0], 2 * s + 1), k_pair<TK>(kr[1], 2 * s + 1)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_op<TK>(sc[nt], a, qb[nt][s]);
    }
    __syncwarp();
    if (it + RING < items) issue(it + RING);   // the slot is free: its k is in registers

    const bool v0 = rl >= n_skip && rl < n_valid;
    const bool v1 = rl + 8 >= n_skip && rl + 8 < n_valid;
    float* sp = scores + (size_t)k * G * PAGE;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // sc[nt][r]: token rl + 8*(r >> 1), query 8*nt + 2*tig + (r & 1)
        const int g = NTILE * nt + 2 * tig + e;
        const float s0 = v0 ? sc[nt][e] : NEG_INF, s1 = v1 ? sc[nt][2 + e] : NEG_INF;
        if (g < G) {   // the padded query rows' scores are not kept
          sp[g * PAGE + rl] = s0;
          sp[g * PAGE + rl + 8] = s1;
        }
        // a query's 16 scores lie in the 8 lanes of one tig, two each
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[nt][e], mx);
        float rs = (v0 ? fast_exp(s0 - m_new) : 0.f) + (v1 ? fast_exp(s1 - m_new) : 0.f);
        rs += __shfl_xor_sync(0xffffffffu, rs, 4);
        rs += __shfl_xor_sync(0xffffffffu, rs, 8);
        rs += __shfl_xor_sync(0xffffffffu, rs, 16);
        l[nt][e] = l[nt][e] * fast_exp(m[nt][e] - m_new) + rs;
        m[nt][e] = m_new;
      }
  }

  // ---- the warps' (m, l) -> the block's -> the cluster's (M, L)
  if (gid == 0)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mlw[warp][NTILE * nt + 2 * tig + e] = make_float2(m[nt][e], l[nt][e]);
  __syncthreads();
  if (tid < GM) {
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int w = 0; w < CW; ++w) M = fmaxf(M, mlw[w][tid].x);
#pragma unroll
    for (int w = 0; w < CW; ++w) L += mlw[w][tid].y * fast_exp(mlw[w][tid].x - M);
    mlb[tid] = make_float2(M, L);
  }
  hw::cluster_sync();
  if (tid < GM) {
    const uint32_t at = hw::smem_addr(&mlb[tid]);
    float2 mc[CLUSTER];
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c) {
      mc[c] = c < C ? hw::ld_cluster_f32x2(hw::map_to_rank(at, c)) : make_float2(NEG_INF, 0.f);
      M = fmaxf(M, mc[c].x);
    }
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c)
      if (c < C) L += mc[c].y * fast_exp(mc[c].x - M);
    Ms[tid] = M;
    Ls[tid] = L;
  }
  __syncthreads();

  // ---- v: O^T (DPC x 8 queries of each n tile) += V^T P^T over the pages
  float o[KS][NT][4];
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[mt][nt][r] = 0.f;
  // the division by L as a product by 1/L: within an ulp of it, which
  // weight_slack's 2^-12 covers; int8's one edge keeps its side (the row's
  // largest weight exp(0) * (1/L) is 1 where L is 1, else below 1)
  float Mq[NT], Linv[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    Mq[nt] = Ms[NTILE * nt + gid];
    Linv[nt] = 1.f / Ls[NTILE * nt + gid];
  }
  for (int it = n_w; it < items; ++it) {
    const int slot = it % RING;
    hw::mbar_wait(&full[warp][slot], (it / RING) & 1);
    const int k = warp + CW * (it - n_w), j = begin + k;
    const int n_valid = min(PAGE, len + 1 - j * PAGE);
    const int n_skip = max(0, lo - j * PAGE);
    // P^T as the B operand: tokens 2tig, 2tig+1 (b0) and 2tig+8, 2tig+9
    // (b1) of query 8*nt + gid; a key that does not count has score NEG_INF
    // and weight 0, a padded query row weight 0
    const float* sp = scores + (size_t)k * G * PAGE;
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = NTILE * nt + gid;
        const float2 s = g < G ? *reinterpret_cast<const float2*>(sp + g * PAGE + 2 * tig + 8 * h)
                               : make_float2(NEG_INF, NEG_INF);
        pb[nt][h] = weights_op<TK>(fast_exp(s.x - Mq[nt]) * Linv[nt],
                                   fast_exp(s.y - Mq[nt]) * Linv[nt]);
      }
    // v rows of the thread's tokens; rows of tokens that do not count read
    // as zeros (their bytes may not be finite, and 0 * NaN is NaN)
    int tok[4];
    bool keep[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      tok[x] = 2 * tig + (x & 1) + 8 * (x >> 1);
      keep[x] = tok[x] >= n_skip && tok[x] < n_valid;
    }
    const uint8_t* pg = ring + slot * PG::BYTES;
#pragma unroll
    for (int c = 0; c < KS / PG::TILES; ++c) {
      // group c: head dims c*SPAN + (SPAN/8)*gid ..., one word a token
      const int byte = c * 32 + 4 * gid + shift;   // in the box's row
      const bool in_box = byte < PG::NBOX * ROW;    // else head dims past D
      uint32_t w[4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
        w[x] = keep[x] && in_box ? *reinterpret_cast<const uint32_t*>(
                             pg + (byte >> 7) * BOX_BYTES + tok[x] * ROW +
                             ((((byte & 127) >> 4) ^ (tok[x] & 7)) << 4) + (byte & 15))
                       : 0u;
#pragma unroll
      for (int h = 0; h < PG::TILES; ++h) {
        uint32_t a[4];
        if constexpr (PG::EB == 1) {
          // rows gid, gid+8 of m tile 2c+h: head dims +2h, +2h+1 of the word
          const uint32_t x01 = __byte_perm(w[0], w[1], h ? 0x7362 : 0x5140);
          const uint32_t x23 = __byte_perm(w[2], w[3], h ? 0x7362 : 0x5140);
          a[0] = op_pair<TK>(x01, 0);
          a[1] = op_pair<TK>(x01, 1);
          a[2] = op_pair<TK>(x23, 0);
          a[3] = op_pair<TK>(x23, 1);
        } else {
          a[0] = __byte_perm(w[0], w[1], 0x5410);
          a[1] = __byte_perm(w[0], w[1], 0x7632);
          a[2] = __byte_perm(w[2], w[3], 0x5410);
          a[3] = __byte_perm(w[2], w[3], 0x7632);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_op<TK>(o[c * PG::TILES + h][nt], a, pb[nt]);
      }
    }
    __syncwarp();
    if (it + RING < items) issue(it + RING);
  }

  // ---- the warps' sums, then the cluster's, into out
  __syncthreads();   // every ring is drained: its memory takes the warps' sums
  float* accs = reinterpret_cast<float*>(base);   // [CW][GM][DPC]
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // o[mt][nt][r]: head dim of row gid + 8*(r >> 1) of m tile mt,
        // query 8*nt + 2*tig + (r & 1)
        const int d = (mt / PG::TILES) * PG::SPAN + (PG::SPAN / 8) * gid +
                      2 * (mt % PG::TILES) + (r >> 1);
        accs[(warp * GM + NTILE * nt + 2 * tig + (r & 1)) * DPC + d] = o[mt][nt][r];
      }
  __syncthreads();
  for (int i = tid; i < GM * DPC; i += CW * 32) {
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < CW; ++w) A += accs[w * GM * DPC + i];
    accs[i] = A;
  }
  hw::cluster_sync();
  const int total = G * D, share = (total + C - 1) / C;
  const int i_end = min(total, ((int)rank + 1) * share);
  for (int i = (int)rank * share + tid; i < i_end; i += CW * 32) {
    const int g = i / D, d = i % D;
    const uint32_t at = hw::smem_addr(accs + g * DPC + d);
    float part[CLUSTER];   // every block's load in flight at once
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c)
      part[c] = c < C ? hw::ld_cluster_f32(hw::map_to_rank(at, c)) : 0.f;
    float A = 0.f;
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c) A += part[c];
    out[((size_t)b * KV + kvh) * G * D + i] = from_f<TQ>(A);
  }
  hw::cluster_sync();   // no block leaves while another reads its shared memory
}

// The pages a sequence spans within the window, most: the table's width,
// or the window's tokens over at most (window - 1) / 16 + 2 pages.
__host__ __device__ constexpr int span_pages(int max_blocks, int window) {
  return window > 0 && (window - 1) / PAGE + 2 < max_blocks ? (window - 1) / PAGE + 2
                                                           : max_blocks;
}

// The launch of the design over every (batch row, kv head); n_pages the
// pool's pages. The cluster's size C: of the sizes that keep a block's
// scores within SCORE_BYTES (at most CLUSTER and the span's pages), the
// largest of those that need the fewest waves of clusters, as
// cudaOccupancyMaxActiveClusters counts them (a block's work is a chain of
// latencies, so a second wave costs about as much as the first; the counts
// are kept per size and shared memory, for the process's card).
// cudaErrorInvalidValue for a table whose scores do not fit SCORE_BYTES at
// C = CLUSTER, or 8-bit pages whose kv heads' rows TMA cannot address (D
// 120 under an odd KV): ops.py cvt_design sends those to the two-pass
// kernels.
template <typename TK, typename TQ, int NT>
cudaError_t launch_cluster(const void* q, const void* kp, const void* vp, const void* tables,
                           const void* lens, void* out, int B, int KV, int G, int D,
                           int max_blocks, int window, float scale, int n_pages,
                           cudaStream_t stream) {
  using PG = Pages<TK>;
  constexpr int GM = NTILE * NT;
  constexpr int SMEM_MAX = region_bytes<NT, TK>() + SCORE_BYTES + 1024;
  const int span = span_pages(max_blocks, window);
  const int fit = SCORE_BYTES / (G * PAGE * 4);   // pages a block's scores may hold
  const int c_min = (span + fit - 1) / fit;
  if (c_min > CLUSTER || n_pages < 1) return cudaErrorInvalidValue;
  const uint64_t row = (uint64_t)D * PG::EB, tok = row * KV;
  const bool flat = row % 16 != 0;
  if (tok % 16 != 0) return cudaErrorInvalidValue;
  const uint64_t dims[4] = {flat ? (uint64_t)KV * D : (uint64_t)D, flat ? 1u : (uint64_t)KV,
                            (uint64_t)PAGE, (uint64_t)n_pages};
  const uint64_t strides[3] = {flat ? tok : row, tok, tok * PAGE};
  const uint32_t box[4] = {ROW / PG::EB, 1, PAGE, 1};
  const CUtensorMapDataType type =
      PG::EB == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tk, tv;
  cudaError_t e = hw::make_tmap_4d(&tk, type, kp, dims, strides, box, 128);
  if (e == cudaSuccess) e = hw::make_tmap_4d(&tv, type, vp, dims, strides, box, 128);
  if (e != cudaSuccess) return e;
  auto kernel = paged_cluster_cvt<TK, TQ, NT>;
  static bool attr_set = false;   // the opt-in above 48 KB, once per instance
  if (!attr_set) {
    e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  auto smem_of = [&](int c) {   // the rings (later the sums), a block's scores, the alignment
    return region_bytes<NT, TK>() + (span + c - 1) / c * G * PAGE * 4 + 1024;
  };
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(CW * 32);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto shape = [&](int c) {
    cfg.gridDim = dim3(c, KV, B);
    cfg.dynamicSmemBytes = smem_of(c);
    attr[0].val.clusterDim.x = c;
  };
  // the clusters of c blocks the card holds at once, by c and shared memory
  static int seen_smem[CLUSTER + 1] = {}, seen_clusters[CLUSTER + 1] = {};
  int C = c_min, fewest = 0;
  for (int c = c_min; c <= CLUSTER && c <= span; ++c) {
    shape(c);
    if (seen_smem[c] != (int)cfg.dynamicSmemBytes) {
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg) != cudaSuccess) {
        n = 0;
        cudaGetLastError();   // the failed query's error, which the launch must not report
      }
      seen_smem[c] = (int)cfg.dynamicSmemBytes;
      seen_clusters[c] = n;
    }
    if (seen_clusters[c] < 1) continue;
    const int waves = (B * KV + seen_clusters[c] - 1) / seen_clusters[c];
    if (fewest == 0 || waves <= fewest) {
      fewest = waves;
      C = c;
    }
  }
  shape(C);
  const int pmax = (span + C - 1) / C;
  e = cudaLaunchKernelEx(&cfg, kernel, tk, tv, static_cast<const TQ*>(q),
                         static_cast<const int*>(tables), static_cast<const int*>(lens),
                         static_cast<TQ*>(out), KV, G, D, max_blocks, window, scale, (int)flat,
                         pmax);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace paged_cluster
