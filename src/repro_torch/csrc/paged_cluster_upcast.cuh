// K2's upcast mode (the reference's decode_unroll lever,
// src/repro/models/transformer.py:472-488, which reads the cache as
// kc[l].astype(q.dtype) before decode_attention) over fp8 e4m3 or int8
// pages under a bf16 q, as one launch of a thread block cluster per (batch
// row, kv head). Included by paged_attention_upcast.cu, beside the split
// kernel of paged_cvt.cuh (ONEPASS), which keeps an fp32 q, fp32 pages
// under a bf16 q, and the split half under seq_shard_decode (its
// partitions are merged across ranks).
//
// Replaces: the Pallas TPU kernel paged_attention_kernel (body
// _paged_kernel, src/repro/kernels/paged_attention/kernel.py:79) for such
// pages under decode_unroll.
//
// The function is ONEPASS's: q*scale rounded to bf16 (q's dtype), each page
// upcast to bf16 (exact for every e4m3 and int8 value), an online softmax
// (m, l) in fp32 with the running weights exp(s - m) rounded to bf16 for
// p.v, fp32 sums, out = acc / l in bf16. It needs no global (M, L) before
// p.v, unlike decode_attention's, so each block keeps (m, l, acc) over its
// own pages and stores no score.
//
// Bound on this card: HBM bytes, each counted key's k and v row read once
// at one byte an element. Design (the cluster of paged_cluster.cuh without
// its stored scores):
// - One cluster of C <= 16 blocks per (batch row, kv head); each block
//   takes a contiguous C-th of the row's pages in its window, its warps (4
//   at G <= 8, 8 at G 9-16) the block's pages in turn. C by paged_cluster's
//   wave cost (cluster_size), from cudaOccupancyMaxActiveClusters.
// - Whole pages by TMA through the 4-d tensor map over the pool (for 8-bit
//   D 120 the flat map under an even KV, the paired map under an odd one:
//   paged_cluster's Paired, slot row s holding token paired_token(s), the
//   masks at the true tokens), a page's k box and v box into
//   one slot of a per-warp ring of URING slots on mbarriers. A warp loads
//   its page's k chunks and v words into registers and reissues the slot
//   before it computes, so the next pages' copies overlap its products.
// - Conversions in registers: an e4m3 pair by one cvt.rn.f16x2.e4m3x2, an
//   int8 pair by a byte permute and an f16x2 subtraction (paged_cluster's
//   op_pair, exact in f16), then to bf16 through fp32 (exact: at most 8
//   significant bits). q*scale is rounded to bf16, which f16 does not
//   hold exactly, so the products run on the bf16 tensor cores (mma.sync
//   m16n8k16, fp32 sums): K Q^T per page, then V^T P^T with the page's
//   rounded weights passed from the score layout to the operand layout
//   through a per-warp bf16 tile in shared memory.
// - The warps' (m, l, acc) merge in shared memory, the blocks' through
//   distributed shared memory (each block's rescale factor exp(m_c - M) /
//   L read by every block), and each block with pages writes its share of
//   the output once. No scratch buffer, no second launch.
// - exp is ex2.approx (fast_exp): within 2^-21 of expf, far inside the
//   bf16 rounding of the weights.
#pragma once

#include "paged_cluster.cuh"

namespace paged_cluster_upcast {

using namespace repro_torch;
using namespace repro_torch::paged;
using paged_cluster::BOX_BYTES;
using paged_cluster::CLUSTER;
using paged_cluster::DPC;
using paged_cluster::Pages;
using paged_cluster::ROW;
using paged_cluster::fast_exp;
using paged_cluster::k_pair;
using paged_cluster::op_pair;
using paged_cluster::span_pages;
using paged_cluster::warps;
namespace hw = repro_torch::hopper;

constexpr int URING = 2;   // pages (k and v) in flight per warp

// An f16x2 pair of e4m3 or int8 values as the bf16x2 pair: exact, since
// each holds at most 8 significant bits (the fp32 value's low half is 0).
__device__ __forceinline__ uint32_t bf16_pair(uint32_t h2) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h2));
  return __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
}

// Dynamic shared memory from a 1024-byte aligned base: each warp's ring
// (URING slots of a k page and a v page); once every ring is drained, the
// warps' fp32 sums (CW x GM x DPC) over it.
template <int NT, typename TK>
__host__ __device__ constexpr int upcast_ring_bytes() {
  return warps<NT>() * URING * 2 * Pages<TK>::BYTES;
}
template <int NT, typename TK>
__host__ __device__ constexpr int upcast_dyn_bytes() {
  return (upcast_ring_bytes<NT, TK>() > warps<NT>() * NTILE * NT * DPC * 4
              ? upcast_ring_bytes<NT, TK>()
              : warps<NT>() * NTILE * NT * DPC * 4) +
         1024;
}

// One cluster per (batch row, kv head) (grid (C, KV, B), cluster dims (C, 1,
// 1)). q and out (B, KV, G, D) bf16; the pages (8-bit TK) through tk and
// tv (flat: the (KV*D, 1, 16, P) map, its box at the 16-byte boundary at
// or before head kvh's row; PAIR: the paired map). NT n tiles of 8
// queries.
template <typename TK, int NT, bool PAIR = false>
__global__ void __launch_bounds__(warps<NT>() * 32)
paged_cluster_upcast(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __nv_bfloat16* __restrict__ q,
                     const int* __restrict__ tables, const int* __restrict__ lens,
                     __nv_bfloat16* __restrict__ out, int KV, int G, int D, int max_blocks,
                     int window, float scale, int flat) {
  using PG = Pages<TK>;
  static_assert(PG::EB == 1, "8-bit pages only");
  constexpr int CW = warps<NT>();
  constexpr int GM = NTILE * NT;   // query rows, padded
  constexpr int KS = DPC / 16;     // k steps of q.k, m tiles of p.v
  constexpr int VG = KS / PG::TILES;   // v groups of a row: one word a token each
  constexpr int QROW = DPC + 2;    // a row of qs: 65 words, so a warp's fragment loads hit 32 banks
  __shared__ __align__(16) uint16_t qs[GM][QROW];
  __shared__ __align__(16) __nv_bfloat16 pw[CW][GM][PAGE + 8];   // a page's rounded weights
  __shared__ float2 mlw[CW][GM];
  __shared__ float2 mlb[GM];       // the block's (m, l), read by the cluster
  __shared__ float fw[CW][GM];     // each warp's rescale factor
  __shared__ float fc[CLUSTER][GM];   // each block's factor exp(m_c - M) / L
  __shared__ __align__(8) uint64_t full[CW][URING];
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
  uint8_t* ring = base + warp * URING * 2 * PG::BYTES;
  const int shift = flat ? (kvh * D) & 15 : 0;   // the row's bytes into its box: 0 or 8
  const paged_cluster::Paired pr(kvh, KV, D);    // PAIR: each half's box and shift

  int pid[2];   // the page ids of the warp's pages lane and lane + 32 (later ones: read at issue)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = lane + 32 * h;
    pid[h] = x < n_w ? tables[(size_t)b * max_blocks + begin + warp + CW * x] : 0;
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < URING; ++s) hw::mbar_init(&full[warp][s], 1);
    hw::mbar_fence_init();
  }
  __syncwarp();
  // the warp's page x (k and v) into its ring slot; every lane calls it,
  // lane 0 issues
  auto issue = [&](int x) {
    const int page = x < 64 ? __shfl_sync(0xffffffffu, x < 32 ? pid[0] : pid[1], x & 31)
                            : tables[(size_t)b * max_blocks + begin + warp + CW * x];
    if (lane == 0) {
      uint8_t* dst = ring + (x % URING) * 2 * PG::BYTES;
      uint64_t* bar = &full[warp][x % URING];
      hw::fence_proxy_async();   // the slot's earlier reads before the copy's writes
      hw::mbar_arrive_expect_tx(bar, 2 * BOX_BYTES);
      if constexpr (PAIR) {
        pr.load(dst, &tk, bar, page);
        pr.load(dst + PG::BYTES, &tv, bar, page);
      } else {
      const int c0 = flat ? kvh * D - shift : 0, c1 = flat ? 0 : kvh;
      hw::tma_load_4d(dst, &tk, bar, c0, c1, 0, page);
      hw::tma_load_4d(dst + PG::BYTES, &tv, bar, c0, c1, 0, page);
      }
    }
  };
  for (int x = 0; x < URING && x < n_w; ++x) issue(x);

  // q*scale rounded to bf16 (q's dtype); query rows G..GM-1 and head dims
  // D..DPC-1 are zeros
  for (int i = tid; i < GM * DPC; i += CW * 32) {
    const int g = i / DPC, d = i % DPC;
    float x = 0.f;
    if (g < G && d < D) x = __bfloat162float(q[(((size_t)b * KV + kvh) * G + g) * D + d]) * scale;
    qs[g][d] = __bfloat16_as_ushort(__float2bfloat16(x));
  }
  __syncthreads();
  // q^T as the B operand of K Q^T, in the k rows' permuted pair order
  uint32_t qb[NT][KS][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qb[nt][s][h] = *reinterpret_cast<const uint32_t*>(
            qs[NTILE * nt + gid] + paged_cluster::dpair<TK>(tig, 2 * s + h));

  // the mma's row gid is token rl (gid's bits rotated: the two rows of a
  // quarter warp lie 4 rows apart, so their swizzled chunks never collide)
  const int rl = (gid >> 1) | ((gid & 1) << 2);
  float m[NT][2], l[NT][2];
  // o[mt][nt][r]: head dim of row gid + 8*(r >> 1) of m tile mt, query
  // 8*nt + 2*tig + (r & 1)
  float o[KS][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[nt][e] = NEG_INF;
      l[nt][e] = 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[mt][nt][r] = 0.f;

  // v's slot rows of the thread: 2tig, 2tig+1 (the B operand's b0) and
  // 2tig+8, 2tig+9 (b1); their tokens (PAIR: paired_token), and those of k's
  // slot rows rl and rl + 8
  int tok[4], tt[4];
#pragma unroll
  for (int x2 = 0; x2 < 4; ++x2) {
    tok[x2] = 2 * tig + (x2 & 1) + 8 * (x2 >> 1);
    tt[x2] = PAIR ? paged_cluster::paired_token(tok[x2]) : tok[x2];
  }
  const int t0 = PAIR ? 2 * rl : rl, t1 = PAIR ? 2 * rl + 1 : rl + 8;

  for (int x = 0; x < n_w; ++x) {
    const int slot = x % URING;
    hw::mbar_wait(&full[warp][slot], (x / URING) & 1);
    const int j = begin + warp + CW * x;
    const int n_valid = min(PAGE, len + 1 - j * PAGE);   // tokens in the sequence
    const int n_skip = max(0, lo - j * PAGE);            // tokens left of the window
    const uint8_t* pg = ring + slot * 2 * PG::BYTES;
    // k rows rl and rl + 8 as the thread's 16-byte chunks
    uint4 kr[2][PG::CHUNKS];
    if constexpr (PAIR) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        paged_cluster::k_row<TK>(kr[r], pg + (rl + 8 * r) * ROW, rl, tig, pr.shift[r], D);
    } else {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < PG::CHUNKS; ++c) {
        const int L = tig + 4 * c;
        const uint8_t* row = pg + (rl + 8 * r) * ROW;
        if (shift == 0) {
          kr[r][c] = *reinterpret_cast<const uint4*>(row + (((L & 7) ^ rl) << 4));
        } else {   // the chunk's halves: the end of box chunk L, the start of L + 1
          const uint2 lo2 = *reinterpret_cast<const uint2*>(row + (((L & 7) ^ rl) << 4) + 8);
          const uint2 hi2 = (L & 7) < 7
                                ? *reinterpret_cast<const uint2*>(row + ((((L & 7) + 1) ^ rl) << 4))
                                : make_uint2(0, 0);
          kr[r][c] = make_uint4(lo2.x, lo2.y, hi2.x, hi2.y);
        }
        if (flat) {   // the next head's bytes past D (4-byte words; D is a multiple of 8)
          const int d0 = L * 16;   // the chunk's first head dim
          if (d0 + 4 > D) kr[r][c].x = 0;
          if (d0 + 8 > D) kr[r][c].y = 0;
          if (d0 + 12 > D) kr[r][c].z = 0;
          if (d0 + 16 > D) kr[r][c].w = 0;
        }
      }
    }
    // v words of the thread's tokens, head dims c*32 + 4*gid ...; rows of
    // tokens that do not count read as zeros (their bytes may not be
    // finite, and 0 * NaN is NaN)
    uint32_t w[VG][4];
#pragma unroll
    for (int c = 0; c < VG; ++c) {
      if constexpr (PAIR) {   // each half's own shift
#pragma unroll
        for (int x2 = 0; x2 < 4; ++x2) {
          const int byte = c * 32 + 4 * gid + pr.shift[x2 >> 1];
          w[c][x2] = byte < ROW && tt[x2] >= n_skip && tt[x2] < n_valid
                         ? paged_cluster::v_word(pg + PG::BYTES, tok[x2], byte)
                         : 0u;
        }
        continue;
      }
      const int byte = c * 32 + 4 * gid + shift;   // in the box's row
      const bool in_box = byte < ROW;               // else head dims past D
#pragma unroll
      for (int x2 = 0; x2 < 4; ++x2)
        w[c][x2] = in_box && tok[x2] >= n_skip && tok[x2] < n_valid
                       ? *reinterpret_cast<const uint32_t*>(
                             pg + PG::BYTES + tok[x2] * ROW +
                             ((((byte & 127) >> 4) ^ (tok[x2] & 7)) << 4) + (byte & 15))
                       : 0u;
    }
    __syncwarp();
    if (x + URING < n_w) issue(x + URING);   // the slot is free: its page is in registers

    // S^T (16 tokens x 8 queries of each n tile) = K Q^T; sc[nt][r]: token
    // rl + 8*(r >> 1), query 8*nt + 2*tig + (r & 1)
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nt][r] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const uint32_t a[4] = {bf16_pair(k_pair<TK>(kr[0], 2 * s)),
                             bf16_pair(k_pair<TK>(kr[1], 2 * s)),
                             bf16_pair(k_pair<TK>(kr[0], 2 * s + 1)),
                             bf16_pair(k_pair<TK>(kr[1], 2 * s + 1))};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) hw::mma_16816(sc[nt], a, qb[nt][s]);
    }

    // the online softmax over the page; the weights rounded to bf16 into pw
    const bool v0 = t0 >= n_skip && t0 < n_valid;
    const bool v1 = t1 >= n_skip && t1 < n_valid;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a query's 16 scores lie in the 8 lanes of one tig, two each
        const float s0 = v0 ? sc[nt][e] : NEG_INF, s1 = v1 ? sc[nt][2 + e] : NEG_INF;
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[nt][e], mx);
        const float alpha = fast_exp(m[nt][e] - m_new);
        const float p0 = v0 ? fast_exp(s0 - m_new) : 0.f;
        const float p1 = v1 ? fast_exp(s1 - m_new) : 0.f;
        float rs = p0 + p1;
        rs += __shfl_xor_sync(0xffffffffu, rs, 4);
        rs += __shfl_xor_sync(0xffffffffu, rs, 8);
        rs += __shfl_xor_sync(0xffffffffu, rs, 16);
        l[nt][e] = l[nt][e] * alpha + rs;
        m[nt][e] = m_new;
#pragma unroll
        for (int mt = 0; mt < KS; ++mt) {
          o[mt][nt][e] *= alpha;
          o[mt][nt][2 + e] *= alpha;
        }
        const int g = NTILE * nt + 2 * tig + e;
        pw[warp][g][rl] = __float2bfloat16(p0);
        pw[warp][g][rl + 8] = __float2bfloat16(p1);
      }
    __syncwarp();
    // P^T as the B operand: tokens 2tig, 2tig+1 (b0) and 2tig+8, 2tig+9 (b1)
    // of query 8*nt + gid
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pb[nt][h] = *reinterpret_cast<const uint32_t*>(&pw[warp][NTILE * nt + gid][2 * tig + 8 * h]);
    // O^T (DPC x 8 queries of each n tile) += V^T P^T
#pragma unroll
    for (int c = 0; c < VG; ++c)
#pragma unroll
      for (int h = 0; h < PG::TILES; ++h) {
        // rows gid, gid+8 of m tile 2c+h: head dims +2h, +2h+1 of the word
        const uint32_t x01 = __byte_perm(w[c][0], w[c][1], h ? 0x7362 : 0x5140);
        const uint32_t x23 = __byte_perm(w[c][2], w[c][3], h ? 0x7362 : 0x5140);
        const uint32_t a[4] = {bf16_pair(op_pair<TK>(x01, 0)), bf16_pair(op_pair<TK>(x01, 1)),
                               bf16_pair(op_pair<TK>(x23, 0)), bf16_pair(op_pair<TK>(x23, 1))};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) hw::mma_16816(o[c * PG::TILES + h][nt], a, pb[nt]);
      }
    __syncwarp();   // pw is written again next page
  }

  // ---- the warps' (m, l, acc) -> the block's
  __syncthreads();   // every ring is drained: its memory takes the warps' sums
  float* accs = reinterpret_cast<float*>(base);   // [CW][GM][DPC]
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = (mt / PG::TILES) * PG::SPAN + (PG::SPAN / 8) * gid +
                      2 * (mt % PG::TILES) + (r >> 1);
        accs[(warp * GM + NTILE * nt + 2 * tig + (r & 1)) * DPC + d] = o[mt][nt][r];
      }
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
    for (int w2 = 0; w2 < CW; ++w2) M = fmaxf(M, mlw[w2][tid].x);
#pragma unroll
    for (int w2 = 0; w2 < CW; ++w2) {
      fw[w2][tid] = fast_exp(mlw[w2][tid].x - M);   // 0 for a warp without pages
      L += mlw[w2][tid].y * fw[w2][tid];
    }
    mlb[tid] = make_float2(M, L);
  }
  __syncthreads();
  for (int i = tid; i < GM * DPC; i += CW * 32) {
    const int g = i / DPC;
    float A = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < CW; ++w2) A += accs[w2 * GM * DPC + i] * fw[w2][g];
    accs[i] = A;
  }
  // ---- the cluster's: every block's factor exp(m_c - M) / L, then its share of out
  hw::cluster_sync();
  if (tid < GM) {
    const uint32_t at = hw::smem_addr(&mlb[tid]);
    float2 mc[CLUSTER];
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c) {
      mc[c] = c < n_act ? hw::ld_cluster_f32x2(hw::map_to_rank(at, c)) : make_float2(NEG_INF, 0.f);
      M = fmaxf(M, mc[c].x);
    }
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c)
      if (c < n_act) L += mc[c].y * fast_exp(mc[c].x - M);
    const float inv = L > 0.f ? 1.f / L : 0.f;
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c) fc[c][tid] = c < n_act ? fast_exp(mc[c].x - M) * inv : 0.f;
  }
  __syncthreads();
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
    for (int c = 0; c < CLUSTER; ++c) A += part[c] * fc[c][g];
    out[((size_t)b * KV + kvh) * G * D + i] = __float2bfloat16(A);
  }
  hw::cluster_sync();   // no block leaves while another reads its shared memory
}

// The launch of one instance over every (batch row, kv head), through
// the pool's maps tk and tv (map: which of paged_cluster's PageMap). C by
// paged_cluster::cluster_size, a warp's chain being a k and a v step for
// each of a block's pages. cudaErrorLaunchOutOfResources where the card
// holds no cluster of any size.
template <typename TK, int NT, bool PAIR>
cudaError_t launch_map(const CUtensorMap& tk, const CUtensorMap& tv, int map, const void* q,
                       const void* tables, const void* lens, void* out, int B, int KV, int G,
                       int D, int max_blocks, int window, float scale, cudaStream_t stream) {
  constexpr int SMEM = upcast_dyn_bytes<NT, TK>();
  cudaError_t e = cudaSuccess;
  const int span = span_pages(max_blocks, window);
  auto kernel = paged_cluster_upcast<TK, NT, PAIR>;
  const void* k = (const void*)kernel;
  static bool opted = false;   // the opt-ins, once per instance
  if (!opted) {
    if ((e = paged_cluster::opt_in(&k, 1, SMEM)) != cudaSuccess) return e;
    opted = true;
  }
  paged_cluster::ClusterLaunch L(warps<NT>() * 32, KV, B, stream);
  static int seen[CLUSTER + 1];   // by c
  const int C = paged_cluster::cluster_size<NT>(
      B, KV, span,
      [&](int c) {
        L.shape(c, SMEM);
        return paged_cluster::active_clusters(seen[c], k, L.cfg);
      },
      [&](int c) { return (2 * ((span + c - 1) / c) + warps<NT>() - 1) / warps<NT>(); });
  if (C == 0) return cudaErrorLaunchOutOfResources;
  L.shape(C, SMEM);
  e = cudaLaunchKernelEx(&L.cfg, kernel, tk, tv, static_cast<const __nv_bfloat16*>(q),
                         static_cast<const int*>(tables), static_cast<const int*>(lens),
                         static_cast<__nv_bfloat16*>(out), KV, G, D, max_blocks, window, scale,
                         (int)(map != paged_cluster::PER_HEAD));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The launch over every (batch row, kv head); n_pages the pool's pages:
// its maps (paged_cluster's make_page_maps), then the instance of the map
// they took.
template <typename TK, int NT>
cudaError_t launch_upcast(const void* q, const void* kp, const void* vp, const void* tables,
                          const void* lens, void* out, int B, int KV, int G, int D,
                          int max_blocks, int window, float scale, int n_pages,
                          cudaStream_t stream) {
  CUtensorMap tk, tv;
  int map = paged_cluster::PER_HEAD;
  const cudaError_t e =
      paged_cluster::make_page_maps<TK>(&tk, &tv, kp, vp, KV, D, n_pages, &map);
  if (e != cudaSuccess) return e;
  return paged_cluster::with_map<TK>(map, [&](auto pair) {
    return launch_map<TK, NT, decltype(pair)::value>(tk, tv, map, q, tables, lens, out, B, KV,
                                                     G, D, max_blocks, window, scale, stream);
  });
}

}  // namespace paged_cluster_upcast
