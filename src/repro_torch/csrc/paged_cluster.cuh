// K2's default mode over pages of another dtype than q (the reference
// model's decode_attention, src/repro/models/attention.py:102-124: q*scale
// rounded to the pages' dtype, the normalised weights exp(s - M) / L
// rounded to it, fp32 sums, out in q's dtype) as one launch that reads each
// counted key's v once and its k once where the block's scores fit its
// shared memory. Included by paged_attention_cvt.cu; the sequence-split
// decode (its (M, L) crosses ranks) takes the two cluster launches of
// paged_split_cluster.cuh, built on its helpers, and the upcast mode the
// cluster of paged_cluster_upcast.cuh.
//
// Replaces: the Pallas TPU kernel paged_attention_kernel (body
// _paged_kernel, src/repro/kernels/paged_attention/kernel.py:79) for pages
// of fp8 e4m3 or int8 under a bf16 or fp32 q, and bf16 pages under an fp32
// q (paged_cvt.cuh's header says why the port computes decode_attention's
// function and not the Pallas kernel's), at every head dim and kv head
// count the configs use: 8-bit rows of D 120 under an odd KV too
// (h2o-danube's one kv head a rank at tp 8), through the paired map below.
//
// Bound on this card: HBM bytes, each counted key's k and v row read once
// at the pages' width (h2o-danube's rank at tp 8, B 16, contexts
// 4,096-6,400 in a window of 4,096, 8-bit: 0.0047119 ms at 3.35 TB/s). The
// weights need each row's global (M, L) before p.v, which a split design
// gets by reading k twice over several launches. Design:
// - One thread block cluster of C <= 16 blocks (above 8 the non-portable
//   size) per (batch row, kv head); each block takes a contiguous C-th of
//   the row's pages in its window, and its warps (4 for G <= 8, 8 for two
//   n tiles of queries: warps()) take the block's pages in turn. A block
//   with no page of its row's share (a row shorter than C pages) returns
//   at once; the others merge over the blocks that have pages. A block's
//   work is a chain of latencies (the pages' copies, about 0.7 us of
//   dependent instructions a page a warp, the cluster's barriers), so the
//   launch picks C by a cost the occupancy gives: the clusters' waves
//   (cudaOccupancyMaxActiveClusters at that C and shared memory) times a
//   wave's fixed time, a warp's chain of pages and the cluster's exchange
//   (launch_cluster).
// - Whole pages come by TMA: a 4-d tensor map over the pool (P, 16, KV, D),
//   a box of one page's 16 token rows of one kv head, 128 bytes a row
//   (8-bit: D <= 128 elements, columns past D zero-filled; bf16: two boxes
//   of 64), 128-byte swizzled. 8-bit rows of D 120 are not 16-byte strided:
//   under an even KV they take a map over (KV*D, 16, P) whose box starts at
//   the 16-byte boundary at or before the head's row (TMA takes no other
//   start there), so an odd head's row lies 8 bytes into the box and is
//   read as two 8-byte halves of neighbouring chunks; the bytes of other
//   heads are masked. Under an odd KV a token's stride (KV*D bytes) is no
//   multiple of 16 either, but a pair of tokens' is: the paired map (PAIR
//   instances; Paired below) brings a page as two boxes of 8 token pairs,
//   the even tokens' rows into slot rows 0-7 and the odd tokens' into rows
//   8-15, each half with its own shift of 0 or 8 bytes; 128 bytes read a
//   row of 120 (1.07x its bytes, as the all-heads map). The masks take
//   each slot row's true token; k and v share the slot order, so p.v needs
//   nothing else. Each warp keeps a ring of RING pages on mbarriers, k's
//   pages first and then v's, so v's first pages are in flight before the
//   cluster barrier.
// - Each block computes its scores from k with mma.sync (m16n8k16, fp32
//   sums) and keeps them in shared memory as fp32 (G query rows x 16
//   tokens x 4 B a page, in slot order; the padded rows of the mma's n
//   tile are not kept), with each warp's running (m, l). The launch
//   reserves the scores of the table's longest share (the runner pads
//   every table to the batch's longest), up to what a block's shared
//   memory holds beside the ring: past that, a block's last pages are its
//   overflow, whose scores count in (m, l) and are not kept; their k comes
//   again by TMA after the cluster's (M, L) and their scores are recomputed
//   (the same instructions on the same bytes: the same values) before p.v.
//   So no length of a table falls back to another design; the bytes read
//   are k + v + the overflow's k.
// - The blocks exchange their (m, l) through distributed shared memory
//   (mapa, ld.shared::cluster, the cluster barrier): every block merges
//   them in the same order into the row's (M, L).
// - Each block forms the rounded weights from its stored scores and runs
//   p.v over its v pages; the blocks' fp32 sums are added through
//   distributed shared memory, each block with pages writing its share of
//   the output once.
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
// - Where the card cannot hold one cluster of any size with the shared
//   memory a launch needs, or a map fails to build, the launch fails
//   (ops.py raises); no other design takes its place.
#pragma once

#include <cuda_fp16.h>

#include <cmath>
#include <type_traits>

#include "paged_cvt.cuh"

namespace paged_cluster {

using namespace repro_torch;
using namespace repro_torch::paged;
using paged_cvt::E4M3;
using paged_cvt::round_to;
namespace hw = repro_torch::hopper;

constexpr int CLUSTER = 16;              // most blocks of a cluster (non-portable above 8)
constexpr int RING = 2;                  // pages in flight per warp
constexpr int DPC = 128;                 // head-dim geometry
constexpr int ROW = 128;                 // bytes of a token row in a box
constexpr int BOX_BYTES = PAGE * ROW;    // one TMA box

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

// Warps of a block: 4 for one n tile of queries (G <= 8), 8 for two. A
// warp's page is a chain of dependent instructions, twice as long at two
// n tiles, and at long rows a block's scores leave room for one block an
// SM: 8 warps keep its schedulers busy there, where 4 warps of several
// blocks an SM serve one n tile better.
template <int NT>
__host__ __device__ constexpr int warps() { return NT == 1 ? 4 : 8; }

// The dynamic shared memory's layout, from a 1024-byte aligned base: each
// warp's ring of RING pages, each warp's scores of one overflow page (G x
// 16 fp32), then the kept pages' scores; once every ring is drained, the
// warps' fp32 sums (CW x GM x DPC) over all of it.
template <int NT, typename TK>
__host__ __device__ constexpr int ring_bytes() { return warps<NT>() * RING * Pages<TK>::BYTES; }
__host__ __device__ constexpr int page_scores(int G) { return G * PAGE * 4; }
template <int NT>
__host__ __device__ constexpr int sums_bytes() { return warps<NT>() * NTILE * NT * DPC * 4; }
// the bytes a launch asks for when a block keeps `keep` pages' scores
template <int NT, typename TK>
__host__ __device__ constexpr int dyn_bytes(int G, int keep) {
  return (ring_bytes<NT, TK>() + (warps<NT>() + keep) * page_scores(G) > sums_bytes<NT>()
              ? ring_bytes<NT, TK>() + (warps<NT>() + keep) * page_scores(G)
              : sums_bytes<NT>()) +
         1024;
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

// The kv head's rows of a page under the paired map (make_page_maps: 8-bit
// rows of D 120 under an odd KV, the (2*KV*D, 1, 8, P) map over token
// pairs): two copies into one ring slot, on its one mbarrier (2 x 1,024 of
// its expected bytes), the even tokens' rows into slot rows 0-7 and the
// odd tokens' into rows 8-15, so slot row i + 8r holds token 2i + r. Each
// half's box starts at the 16-byte boundary at or before its row (byte
// (r*KV + kvh)*D of the pair), which lies shift[r] bytes into the box: 0
// or 8, and under an odd KV exactly one of the two is 8. The box's bytes
// past the pair read as zeros, and those of the next head or token are
// masked as the all-heads map's.
struct Paired {
  int x0[2];      // each half's box start, bytes (the map's elements) into the pair
  int shift[2];   // each half's row's bytes into its box rows
  __device__ Paired(int kvh, int KV, int D) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = (r * KV + kvh) * D;
      shift[r] = at & 15;
      x0[r] = at - shift[r];
    }
  }
  __device__ __forceinline__ void load(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                       int page) const {
    hw::tma_load_4d(dst, map, bar, x0[0], 0, 0, page);
    hw::tma_load_4d(dst + BOX_BYTES / 2, map, bar, x0[1], 0, 0, page);
  }
};

// The token of its page that slot row s holds under the paired map.
__device__ __forceinline__ int paired_token(int s) { return 2 * (s & 7) + (s >> 3); }

// The thread's 16-byte chunks of one 8-bit k row at `row` (128 bytes,
// 128-byte swizzled: slot row s's chunks XOR s & 7 = rl) whose bytes lie
// `shift` (0 or 8) into it: chunk c is the row's chunk tig + 4c; at shift
// 8 each chunk's halves come from two box chunks. The next head's or
// token's bytes past D read as zeros (4-byte words; D is a multiple of 8).
template <typename TK>
__device__ __forceinline__ void k_row(uint4 (&kr)[Pages<TK>::CHUNKS], const uint8_t* row, int rl,
                                      int tig, int shift, int D) {
  static_assert(Pages<TK>::EB == 1, "8-bit rows");
#pragma unroll
  for (int c = 0; c < Pages<TK>::CHUNKS; ++c) {
    const int L = tig + 4 * c;
    if (shift == 0) {
      kr[c] = *reinterpret_cast<const uint4*>(row + ((L ^ rl) << 4));
    } else {
      const uint2 lo = *reinterpret_cast<const uint2*>(row + ((L ^ rl) << 4) + 8);
      const uint2 hi = L < 7 ? *reinterpret_cast<const uint2*>(row + (((L + 1) ^ rl) << 4))
                             : make_uint2(0, 0);
      kr[c] = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    const int d0 = L * 16;
    if (d0 + 4 > D) kr[c].x = 0;
    if (d0 + 8 > D) kr[c].y = 0;
    if (d0 + 12 > D) kr[c].z = 0;
    if (d0 + 16 > D) kr[c].w = 0;
  }
}

// One word (4 bytes) of the 8-bit v row in slot row `tok` of the slot at
// pg, at `byte` of its 128-byte box row (swizzled by tok & 7).
__device__ __forceinline__ uint32_t v_word(const uint8_t* pg, int tok, int byte) {
  return *reinterpret_cast<const uint32_t*>(pg + tok * ROW + (((byte >> 4) ^ (tok & 7)) << 4) +
                                            (byte & 15));
}

// One cluster per (batch row, kv head) (the grid (C, KV, B), cluster dims
// (C, 1, 1)). q and out (B, KV, G, D) of TQ; the pages through tk and tv
// (flat: the (KV*D, 1, 16, P) map, its box at the 16-byte boundary at or
// before head kvh's row, kvh*D bytes; PAIR: the paired map, Paired); keep
// the pages whose scores a block keeps (dyn_bytes' layout), the rest of its
// pages its overflow. NT n tiles of 8 queries. OVER: the instance with the
// overflow's path, for launches whose blocks may have more pages than they
// keep; without it (keep at least every block's pages) p.v's sums never
// share the registers with a page of k, and the instance takes fewer
// registers. PAIR: the instance of the paired map (8-bit pages; flat 1),
// whose slot row s holds token paired_token(s); the others' code is as it
// was without it.
template <typename TK, typename TQ, int NT, bool OVER, bool PAIR = false>
__global__ void __launch_bounds__(warps<NT>() * 32)
paged_cluster_cvt(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const TQ* __restrict__ q, const int* __restrict__ tables,
                  const int* __restrict__ lens, TQ* __restrict__ out, int KV, int G, int D,
                  int max_blocks, int window, float scale, int flat, int keep) {
  using PG = Pages<TK>;
  constexpr int CW = warps<NT>();
  constexpr int GM = NTILE * NT;   // query rows, padded
  constexpr int KS = DPC / 16;     // k steps of q.k, m tiles of p.v
  constexpr int QROW = DPC + 2;    // a row of qs: 65 words, so a warp's fragment loads hit 32 banks
  __shared__ __align__(16) uint16_t qs[GM][QROW];
  __shared__ float2 mlw[CW][GM];
  __shared__ float2 mlb[GM];       // the block's (m, l), read by the cluster
  __shared__ float Ms[GM], Ls[GM];
  __shared__ __align__(8) uint64_t full[CW][RING];
  extern __shared__ uint8_t dsmem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dsmem) + 1023) & ~static_cast<uintptr_t>(1023));

  const int C = gridDim.x;
  const uint32_t rank = hw::cluster_ctarank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // the block's pages: a C-th of the sequence's in its window; the blocks
  // past the last page have nothing, and the rest merge without them
  const int len = lens[b];
  const int lo = window_start(len, window);
  const int p_lo = lo / PAGE;
  const int n = max(0, pages_used(len, max_blocks) - p_lo);
  const int per = max(1, (n + C - 1) / C);
  const int n_act = max(1, (n + per - 1) / per);   // blocks with pages (rank 0 at least)
  if ((int)rank >= n_act) return;
  const int begin = p_lo + (int)rank * per;
  const int n_b = max(0, min(per, n - (int)rank * per));
  const int n_w = n_b > warp ? (n_b - warp + CW - 1) / CW : 0;   // this warp's pages
  // the warp's kept pages are its first x_keep (block page warp + CW x < keep)
  const int x_keep = !OVER ? n_w : keep > warp ? min(n_w, (keep - warp + CW - 1) / CW) : 0;
  // k's pages; then v's, each overflow page's k again before its v
  const int items = n_w + x_keep + 2 * (n_w - x_keep);
  uint8_t* ring = base + warp * RING * PG::BYTES;
  float* spill = reinterpret_cast<float*>(base + ring_bytes<NT, TK>()) + warp * G * PAGE;
  float* scores = reinterpret_cast<float*>(base + ring_bytes<NT, TK>()) + CW * G * PAGE;
  const int nbox = (D * PG::EB + ROW - 1) / ROW;                  // boxes a row fills
  const int shift = flat ? (kvh * D) & 15 : 0;   // the row's bytes into its box: 0 or 8
  const Paired pr(kvh, KV, D);                   // PAIR: each half's box and shift

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
  // item it: (is v, the warp's page x)
  auto item = [&](int it, int& x) -> bool {
    if (it < n_w) {
      x = it;
      return false;
    }
    const int j = it - n_w;
    if (j < x_keep) {
      x = j;
      return true;
    }
    x = x_keep + ((j - x_keep) >> 1);
    return (j - x_keep) & 1;
  };
  // item it into its ring slot; every lane calls it, lane 0 issues
  const CUtensorMap* maps[2] = {&tk, &tv};
  auto issue = [&](int it) {
    int x;
    const bool is_v = item(it, x);
    const int page = x < 64 ? __shfl_sync(0xffffffffu, x < 32 ? pid[0] : pid[1], x & 31)
                            : tables[(size_t)b * max_blocks + begin + warp + CW * x];
    if (lane == 0) {
      uint8_t* dst = ring + (it % RING) * PG::BYTES;
      uint64_t* bar = &full[warp][it % RING];
      hw::fence_proxy_async();   // the slot's earlier reads before the copy's writes
      hw::mbar_arrive_expect_tx(bar, nbox * BOX_BYTES);
      if constexpr (PAIR)
        pr.load(dst, maps[is_v], bar, page);
      else
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
  auto q_frag = [&](int nt, int i) {
    return *reinterpret_cast<const uint32_t*>(qs[NTILE * nt + gid] + dpair<TK>(tig, i));
  };
  uint32_t qb[NT][KS][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      qb[nt][s][0] = q_frag(nt, 2 * s);
      qb[nt][s][1] = q_frag(nt, 2 * s + 1);
    }

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
  // Item it, k's page x (block page warp + CW x): its scores into sp
  // (nullptr: not kept) and, with `stats`, into the warp's (m, l); the
  // slot's next item is issued once k is in registers. The overflow's
  // second reading (no stats) runs the same products on the same bytes, so
  // its scores equal the first reading's; it takes q's fragments from qs
  // one k step at a time, so that they are not live beside p.v's sums.
  auto k_page = [&](int it, int x, float* sp, auto stats_t) {
    constexpr bool stats = decltype(stats_t)::value;
    const int slot = it % RING;
    hw::mbar_wait(&full[warp][slot], (it / RING) & 1);
    const int j = begin + warp + CW * x;
    const int n_valid = min(PAGE, len + 1 - j * PAGE);   // tokens in the sequence
    const int n_skip = max(0, lo - j * PAGE);            // tokens left of the window
    const uint8_t* pg = ring + slot * PG::BYTES;
    uint4 kr[2][PG::CHUNKS];
    if constexpr (PAIR) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        k_row<TK>(kr[r], pg + (rl + 8 * r) * ROW, rl, tig, pr.shift[r], D);
    } else {
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
      for (int nt = 0; nt < NT; ++nt) {
        if constexpr (stats) {
          mma_op<TK>(sc[nt], a, qb[nt][s]);
        } else {
          const uint32_t b2[2] = {q_frag(nt, 2 * s), q_frag(nt, 2 * s + 1)};
          mma_op<TK>(sc[nt], a, b2);
        }
      }
    }
    __syncwarp();
    if (it + RING < items) issue(it + RING);   // the slot is free: its k is in registers

    // the tokens of slot rows rl and rl + 8 (PAIR: 2rl and 2rl + 1)
    const int t0 = PAIR ? 2 * rl : rl, t1 = PAIR ? 2 * rl + 1 : rl + 8;
    const bool v0 = t0 >= n_skip && t0 < n_valid;
    const bool v1 = t1 >= n_skip && t1 < n_valid;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // sc[nt][r]: slot row rl + 8*(r >> 1), query 8*nt + 2*tig + (r & 1)
        const int g = NTILE * nt + 2 * tig + e;
        const float s0 = v0 ? sc[nt][e] : NEG_INF, s1 = v1 ? sc[nt][2 + e] : NEG_INF;
        if (sp != nullptr && g < G) {   // the padded query rows' scores are not kept
          sp[g * PAGE + rl] = s0;
          sp[g * PAGE + rl + 8] = s1;
        }
        if constexpr (!stats) continue;
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
  };

  // ---- k: the kept pages' scores into shared memory, every page's into (m, l)
  for (int x = 0; x < n_w; ++x)
    k_page(x, x, x < x_keep ? scores + (size_t)(warp + CW * x) * G * PAGE : nullptr,
           std::true_type{});

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
      mc[c] = c < n_act ? hw::ld_cluster_f32x2(hw::map_to_rank(at, c))
                        : make_float2(NEG_INF, 0.f);
      M = fmaxf(M, mc[c].x);
    }
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c)
      if (c < n_act) L += mc[c].y * fast_exp(mc[c].x - M);
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
  // item it, v's page x, with its scores at sp
  auto v_page = [&](int it, int x, const float* sp) {
    const int j = begin + warp + CW * x;
    const int slot = it % RING;
    hw::mbar_wait(&full[warp][slot], (it / RING) & 1);
    const int n_valid = min(PAGE, len + 1 - j * PAGE);
    const int n_skip = max(0, lo - j * PAGE);
    // P^T as the B operand: tokens 2tig, 2tig+1 (b0) and 2tig+8, 2tig+9
    // (b1) of query 8*nt + gid; a key that does not count has score NEG_INF
    // and weight 0, a padded query row weight 0
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
    bool keep_row[4];
#pragma unroll
    for (int x2 = 0; x2 < 4; ++x2) {
      tok[x2] = 2 * tig + (x2 & 1) + 8 * (x2 >> 1);   // slot rows
      const int t = PAIR ? paired_token(tok[x2]) : tok[x2];
      keep_row[x2] = t >= n_skip && t < n_valid;
    }
    const uint8_t* pg = ring + slot * PG::BYTES;
#pragma unroll
    for (int c = 0; c < KS / PG::TILES; ++c) {
      // group c: head dims c*SPAN + (SPAN/8)*gid ..., one word a token
      uint32_t w[4];
      if constexpr (PAIR) {   // each half's own shift; one box
#pragma unroll
        for (int x2 = 0; x2 < 4; ++x2) {
          const int byte = c * 32 + 4 * gid + pr.shift[x2 >> 1];
          w[x2] = keep_row[x2] && byte < ROW ? v_word(pg, tok[x2], byte) : 0u;
        }
      } else {
      const int byte = c * 32 + 4 * gid + shift;   // in the box's row
      const bool in_box = byte < PG::NBOX * ROW;    // else head dims past D
#pragma unroll
      for (int x2 = 0; x2 < 4; ++x2)
        w[x2] = keep_row[x2] && in_box ? *reinterpret_cast<const uint32_t*>(
                               pg + (byte >> 7) * BOX_BYTES + tok[x2] * ROW +
                               ((((byte & 127) >> 4) ^ (tok[x2] & 7)) << 4) + (byte & 15))
                         : 0u;
      }
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
    __syncwarp();   // the slot's and the spill's reads before they are written again
    if (it + RING < items) issue(it + RING);
  };
  // the kept pages, then the overflow: each page's k again, its scores
  // into the warp's spill, then its v
  for (int x = 0; x < x_keep; ++x)
    v_page(n_w + x, x, scores + (size_t)(warp + CW * x) * G * PAGE);
  if constexpr (OVER)
    for (int x = x_keep, it = n_w + x_keep; x < n_w; ++x, it += 2) {
      k_page(it, x, spill, std::false_type{});
      __syncwarp();
      v_page(it + 1, x, spill);
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
  const int total = G * D, share = (total + n_act - 1) / n_act;
  const int i_end = min(total, ((int)rank + 1) * share);
  for (int i = (int)rank * share + tid; i < i_end; i += CW * 32) {
    const int g = i / D, d = i % D;
    const uint32_t at = hw::smem_addr(accs + g * DPC + d);
    float part[CLUSTER];   // every block's load in flight at once
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c)
      part[c] = c < n_act ? hw::ld_cluster_f32(hw::map_to_rank(at, c)) : 0.f;
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

// Host helpers of the cluster launches: this design's, the upcast mode's
// (paged_cluster_upcast.cuh) and the split passes' (paged_split_cluster.cuh).

// The tensor maps a pool of (PAGE, KV, D) TK values takes: per kv head
// (rows of a multiple of 16 bytes); over all heads' rows of a token (8-bit
// rows of D 120 under an even KV: a token's KV*D bytes are a 16-byte
// stride); over token pairs (under an odd KV: Paired).
enum PageMap { PER_HEAD = 0, FLAT = 1, PAIRED = 2 };

// The 4-d tensor maps over the k and v pools, n_pages pages of (PAGE, KV,
// D) TK values, each box ROW bytes of a row, 128-byte swizzle: per head,
// a box of a page's 16 token rows; FLAT, (KV*D, 1, 16, P) with the box at
// the 16-byte boundary at or before the head's row, since TMA faults on
// another start; PAIRED, (2*KV*D, 1, 8, P) over token pairs with strides
// (2*KV*D, 2*KV*D, 16*KV*D) bytes, a box of 8 pairs' 128 bytes (two boxes
// a page: Paired). *map says which. cudaErrorInvalidValue for an empty
// pool or a row that is no multiple of 8 bytes.
template <typename TK>
cudaError_t make_page_maps(CUtensorMap* tk, CUtensorMap* tv, const void* kp, const void* vp,
                           int KV, int D, int n_pages, int* map) {
  using PG = Pages<TK>;
  const uint64_t row = (uint64_t)D * PG::EB, tok = row * KV;
  if (n_pages < 1 || row % 8 != 0) return cudaErrorInvalidValue;
  *map = row % 16 == 0 ? PER_HEAD : tok % 16 == 0 ? FLAT : PAIRED;
  const uint64_t dims[4] = {*map == PER_HEAD ? (uint64_t)D : (*map == FLAT ? 1 : 2) * KV * D,
                            *map == PER_HEAD ? (uint64_t)KV : 1u,
                            (uint64_t)(*map == PAIRED ? PAGE / 2 : PAGE), (uint64_t)n_pages};
  const uint64_t pitch = *map == PAIRED ? 2 * tok : tok;   // a box row's stride
  const uint64_t strides[3] = {*map == PER_HEAD ? row : pitch, pitch, tok * PAGE};
  const uint32_t box[4] = {ROW / PG::EB, 1, (uint32_t)(*map == PAIRED ? PAGE / 2 : PAGE), 1};
  const CUtensorMapDataType type =
      PG::EB == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t e = hw::make_tmap_4d(tk, type, kp, dims, strides, box, 128);
  if (e == cudaSuccess) e = hw::make_tmap_4d(tv, type, vp, dims, strides, box, 128);
  return e;
}

// Calls f with std::bool_constant<PAIR>: true for the paired map, which
// only 8-bit pages take (a bf16 row of D, a multiple of 8, is 16-byte
// strided), so no other page type instantiates it.
template <typename TK, typename F>
cudaError_t with_map(int map, F&& f) {
  if constexpr (Pages<TK>::EB == 1)
    if (map == PAIRED) return f(std::true_type{});
  if (map == PAIRED) return cudaErrorInvalidValue;
  return f(std::false_type{});
}

// The opt-ins of n kernel instances: smem bytes of dynamic shared memory
// and clusters past 8 blocks.
inline cudaError_t opt_in(const void* const* kernels, int n, int smem) {
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < n && e == cudaSuccess; ++i)
    if ((e = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) == cudaSuccess)
      e = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// A launch of clusters over (c, KV, B) blocks of `threads` threads;
// shape(c, smem) sets the grid, the cluster's size c and the dynamic
// shared memory.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  int KV, B;
  ClusterLaunch(int threads, int KV_, int B_, cudaStream_t stream) : KV(KV_), B(B_) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.blockDim = dim3(threads);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;   // cfg points at attr
  void shape(int c, int smem) {
    cfg.gridDim = dim3(c, KV, B);
    cfg.dynamicSmemBytes = smem;
    attr[0].val.clusterDim.x = c;
  }
};

// The clusters of cfg's shape the card holds at once, asked of
// cudaOccupancyMaxActiveClusters once: seen keeps that count + 1, 0 until
// asked (a static array of them needs no set-up). A failed query counts no
// cluster, and its error, which the launch must not report, is cleared.
inline int active_clusters(int& seen, const void* kernel, const cudaLaunchConfig_t& cfg) {
  if (seen == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
      n = 0;
      cudaGetLastError();
    }
    seen = n + 1;
  }
  return seen - 1;
}

// The cluster's size C for B * KV clusters: of 1..CLUSTER (and the span's
// pages), the one whose waves of clusters (active(c): the clusters of c
// blocks the card holds at once) times (a wave's fixed time + chain(c), a
// warp's chain of page steps at c + the exchange's half a page step a
// block) is least, the largest of equals; 0 where the card holds no
// cluster of any size. A block's work is a chain of latencies, so waves
// count whole up to two (a second wave of rows alike costs a whole chain);
// past that by their mean (rows of a batch differ in length, and the last
// wave's clusters overlap the others' tails). A wave's fixed time (the
// launch, q, the first copies, the cluster's barriers, the sums'
// exchange), about 10 us, in a warp's page steps: about 0.7 us a page at
// one n tile and 4 warps, 1.3 us at two and 8 (H100).
template <int NT, typename Active, typename Chain>
int cluster_size(int B, int KV, int span, Active active, Chain chain) {
  constexpr int WAVE_PAGES = NT == 1 ? 16 : 8;
  int C = 0;
  double least = 0.0;
  for (int c = 1; c <= CLUSTER && c <= span; ++c) {
    const int n = active(c);
    if (n < 1) continue;
    const double w = (double)(B * KV) / n;
    const double waves = w <= 2.0 ? std::ceil(w) : w;
    const double cost = waves * (WAVE_PAGES + chain(c) + 0.5 * c);
    if (C == 0 || cost <= least) {
      least = cost;
      C = c;
    }
  }
  return C;
}

// The launch of the design over every (batch row, kv head); n_pages the
// pool's pages. A block of a cluster of c takes at most per = ceil(span /
// c) pages and keeps the scores of as many of them as its shared memory
// holds beside the ring (the opt-in most a block may ask for; the request
// rounded up to 8 KB, so a decode's growing table changes it rarely). C by
// cluster_size, a warp's chain being its k's and v's pages and the
// overflow's k again; the counts of clusters are kept per instance, size
// and shared memory, for the process's card. A launch whose blocks keep
// every page runs the instance without the overflow's path; the paired
// map its PAIR instances. cudaErrorLaunchOutOfResources where the card
// holds no cluster of any size.
template <typename TK, typename TQ, int NT, bool PAIR>
cudaError_t launch_map(const CUtensorMap& tk, const CUtensorMap& tv, int map, const void* q,
                       const void* tables, const void* lens, void* out, int B, int KV, int G,
                       int D, int max_blocks, int window, float scale, cudaStream_t stream) {
  constexpr int STEP = 8 * 1024;                   // the requests' granularity
  constexpr int NSTEP = 232448 / STEP + 1;
  cudaError_t e = cudaSuccess;
  const int span = span_pages(max_blocks, window);
  // the instances without and with the overflow's path
  auto plain = paged_cluster_cvt<TK, TQ, NT, false, PAIR>;
  auto over = paged_cluster_cvt<TK, TQ, NT, true, PAIR>;
  const void* kernels[2] = {(const void*)plain, (const void*)over};
  // the most dynamic shared memory a block may ask for (the card's opt-in
  // limit less the kernels' static shared memory), and the opt-ins, once
  // per instance
  static int cap = 0;
  if (cap == 0) {
    int dev = 0, optin = 0, c = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess)
      return e;
    for (const void* k : kernels) {
      cudaFuncAttributes fa;
      if ((e = cudaFuncGetAttributes(&fa, k)) != cudaSuccess) return e;
      const int ck = (optin - (int)fa.sharedSizeBytes) / STEP * STEP;
      c = c == 0 || ck < c ? ck : c;
    }
    if ((e = opt_in(kernels, 2, c)) != cudaSuccess) return e;
    cap = c;
  }
  // a block of a cluster of c: its pages, those whose scores it keeps, and
  // the bytes it asks for
  auto per_of = [&](int c) { return (span + c - 1) / c; };
  auto keep_of = [&](int c) {
    const int room =
        (cap - 1024 - ring_bytes<NT, TK>() - warps<NT>() * page_scores(G)) / page_scores(G);
    return per_of(c) < room ? per_of(c) : room;
  };
  auto smem_of = [&](int c) {
    const int bytes = (dyn_bytes<NT, TK>(G, keep_of(c)) + STEP - 1) / STEP * STEP;
    return bytes < cap ? bytes : cap;
  };
  if (keep_of(1) < 0) return cudaErrorLaunchOutOfResources;
  // a block of a cluster of c has pages past those it keeps: the
  // overflow's instance
  auto over_of = [&](int c) { return keep_of(c) < per_of(c) ? 1 : 0; };
  ClusterLaunch L(warps<NT>() * 32, KV, B, stream);
  static int seen[2][CLUSTER + 1][NSTEP];   // by instance, c and shared memory
  const int C = cluster_size<NT>(
      B, KV, span,
      [&](int c) {
        L.shape(c, smem_of(c));
        return active_clusters(seen[over_of(c)][c][smem_of(c) / STEP], kernels[over_of(c)],
                               L.cfg);
      },
      [&](int c) {
        return (2 * per_of(c) + per_of(c) - keep_of(c) + warps<NT>() - 1) / warps<NT>();
      });
  if (C == 0) return cudaErrorLaunchOutOfResources;
  L.shape(C, smem_of(C));
  e = cudaLaunchKernelEx(&L.cfg, over_of(C) ? over : plain, tk, tv, static_cast<const TQ*>(q),
                         static_cast<const int*>(tables), static_cast<const int*>(lens),
                         static_cast<TQ*>(out), KV, G, D, max_blocks, window, scale,
                         (int)(map != PER_HEAD), keep_of(C));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The design's launch: the pool's maps (n_pages its pages), then the
// instances of the map they took (launch_map).
template <typename TK, typename TQ, int NT>
cudaError_t launch_cluster(const void* q, const void* kp, const void* vp, const void* tables,
                           const void* lens, void* out, int B, int KV, int G, int D,
                           int max_blocks, int window, float scale, int n_pages,
                           cudaStream_t stream) {
  CUtensorMap tk, tv;
  int map = PER_HEAD;
  const cudaError_t e = make_page_maps<TK>(&tk, &tv, kp, vp, KV, D, n_pages, &map);
  if (e != cudaSuccess) return e;
  return with_map<TK>(map, [&](auto pair) {
    return launch_map<TK, TQ, NT, decltype(pair)::value>(tk, tv, map, q, tables, lens, out, B,
                                                         KV, G, D, max_blocks, window, scale,
                                                         stream);
  });
}

}  // namespace paged_cluster
