// K2's default mode over pages of another dtype than q (the reference
// model's decode_attention, src/repro/models/attention.py:102-124: q*scale
// rounded to the pages' dtype, the normalised weights exp(s - M) / L
// rounded to it, fp32 sums) under a sequence split (seq_shard_decode: each
// rank holds a share of every sequence's positions), as two launches of a
// thread block cluster a rank. Included by paged_attention_split.cu; built
// on the helpers of the one-launch design (paged_cluster.cuh: a whole
// sequence on one device), its three tensor maps included: 8-bit rows of D
// 120 under an odd KV come through the paired map (Paired).
//
// Replaces: the Pallas TPU kernel paged_attention_kernel (body
// _paged_kernel, src/repro/kernels/paged_attention/kernel.py:79) in the
// sequence-split form of decode_attention, whose weights are normalised by
// the WHOLE sequence's (M, L) before they are rounded: under a split that
// (M, L) crosses ranks, so a rank cannot finish its share in one pass.
//
// Bound on this card: HBM bytes. For each counted key and kv head at 8-bit
// pages, pass 1 reads k (D B) and writes its fp32 scores (4G B), pass 2
// reads the scores (4G B) and v (D B): 2D + 8G B in all, where a partition
// design reads 3D (k, then k and v again) plus a partial of G x D a
// 16-page partition. The design does not cut bytes (at G 16, D 128 the two
// counts are equal); it fetches them as the one-launch cluster does, whole
// pages by TMA into a per-warp ring on mbarriers, with one launch a pass
// and one partial a rank:
// - Pass 1 (paged_split_stats): one cluster of C <= 16 blocks per (batch
//   row, kv head) over the rank's share of the table, each block a
//   contiguous C-th of the share's pages in its window, its warps (4 at G
//   <= 8, 8 at G 9-16) the block's pages in turn, C by paged_cluster's
//   wave cost (cluster_size). k pages come through paged_cluster's 4-d
//   tensor map (for 8-bit D 120 the all-heads map under an even KV, the
//   paired map under an odd one, whose slot row s holds token
//   paired_token(s)); q*scale is rounded to the pages' dtype and the
//   scores computed with mma.sync on the converted operands (k_chunks
//   below, paged_cluster's k_row, k_pair and op_pair).
//   Each warp stores its pages' fp32 scores, G x 16 a page in (B, KV,
//   max_blocks, G, 16) at their true tokens, and keeps a running (m, l);
//   the warps' and then the blocks' (m, l) merge in shared and distributed
//   shared memory, and block 0 writes ONE (m, l) per query row for the
//   share. A share with no key that counts (wholly before the window, or
//   past the newest token) writes (NEG_INF, 0).
// - Pass 2 (paged_split_values): one cluster per (batch row, kv head).
//   Every block first merges the R ranks' gathered (m, l) (B, KV, R, G, 2)
//   in rank order into the sequence's (M, L): the same instructions on the
//   same values on every block and every rank. Its warps then stream each
//   page's v box (TMA, the 4-d map) and its scores (one bulk copy of G x 64
//   bytes) into one ring slot, form round(exp(s - M) / L) in the pages'
//   dtype with the one-launch cluster's instructions (weights_b, on
//   paged_cluster's weights_op and fast_exp; each slot row's weight from
//   its token's score) and run p.v on the tensor cores over the pages as
//   stored (pv_page); k is not read. The warps' and blocks' fp32 sums add
//   in shared and distributed shared memory, and each block with pages
//   writes its share of the rank's one partial (B, KV, G, D). part_sum
//   (paged_cvt.cuh) adds the R partials.
// So the split decode takes 3 launches a layer (pass 1, pass 2, the sum)
// and R partials, where a partition design took four (k read twice).
// Where the card holds no cluster of any size, or a map fails to
// build, a pass fails (ops.py raises); no other design takes its place.
#pragma once

#include "paged_cluster.cuh"

namespace paged_split_cluster {

using namespace repro_torch;
using namespace repro_torch::paged;
using paged_cluster::BOX_BYTES;
using paged_cluster::CLUSTER;
using paged_cluster::DPC;
using paged_cluster::Pages;
using paged_cluster::RING;
using paged_cluster::ROW;
using paged_cluster::fast_exp;
using paged_cluster::k_pair;
using paged_cluster::mma_op;
using paged_cluster::op_pair;
using paged_cluster::weights_op;
using paged_cluster::span_pages;
using paged_cluster::warps;
using paged_cvt::round_to;
namespace hw = repro_torch::hopper;

// The loops of paged_cluster_cvt's page steps, as functions of their own:
// the one-launch kernel keeps them inline as they are (taking these
// functions there changed its SASS), these passes call them.

// The thread's 16-byte chunks of k rows rl and rl + 8 of a page whose
// boxes lie at pg (128-byte rows, 128-byte swizzled): chunk c of a row is
// the row's chunk tig + 4c. shift 8 (the flat map, an odd head's row 8
// bytes into its box): each chunk's halves come from two box chunks; flat:
// the next head's bytes past D read as zeros.
template <typename TK>
__device__ __forceinline__ void k_chunks(uint4 (&kr)[2][Pages<TK>::CHUNKS], const uint8_t* pg,
                                         int rl, int tig, int shift, int flat, int D) {
  using PG = Pages<TK>;
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

// P^T as the B operand of V^T P^T from a page's fp32 scores at sp (G x
// 16, in token order): slot rows 2tig, 2tig+1 (b0) and 2tig+8, 2tig+9 (b1)
// of query 8*nt + gid (PAIR: their tokens 4tig + h and 4tig + 2 + h, h the
// half), each weight exp(s - M) * (1/L) rounded to the pages' dtype; a key
// that does not count has score NEG_INF and weight 0, a padded query row
// weight 0.
template <typename TK, int NT, bool PAIR = false>
__device__ __forceinline__ void weights_b(uint32_t (&pb)[NT][2], const float* sp, int G, int gid,
                                          int tig, const float (&Mq)[NT],
                                          const float (&Linv)[NT]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = NTILE * nt + gid;
      float2 s = make_float2(NEG_INF, NEG_INF);
      if constexpr (PAIR) {
        if (g < G) s = make_float2(sp[g * PAGE + 4 * tig + h], sp[g * PAGE + 4 * tig + 2 + h]);
      } else {
        s = g < G ? *reinterpret_cast<const float2*>(sp + g * PAGE + 2 * tig + 8 * h)
                  : make_float2(NEG_INF, NEG_INF);
      }
      pb[nt][h] = weights_op<TK>(fast_exp(s.x - Mq[nt]) * Linv[nt],
                                 fast_exp(s.y - Mq[nt]) * Linv[nt]);
    }
}

// O^T (DPC x 8 queries of each n tile) += V^T P^T over a page of v whose
// boxes lie at pg: the thread's slot rows tok (2tig, 2tig+1, 2tig+8,
// 2tig+9) as 4-byte words of each v group, interleaved by byte permutes
// into the A operand; the rows of tokens that do not count (keep_row
// false) read as zeros (their bytes may not be finite, and 0 * NaN is
// NaN). shift: the rows' bytes into their box rows (PAIR: slot rows 0-7
// shift, 8-15 shift1).
template <typename TK, int NT, bool PAIR = false>
__device__ __forceinline__ void pv_page(float (&o)[DPC / 16][NT][4], const uint8_t* pg,
                                        const uint32_t (&pb)[NT][2], const int (&tok)[4],
                                        const bool (&keep_row)[4], int gid, int shift,
                                        int shift1 = 0) {
  using PG = Pages<TK>;
  constexpr int KS = DPC / 16;
#pragma unroll
  for (int c = 0; c < KS / PG::TILES; ++c) {
    // group c: head dims c*SPAN + (SPAN/8)*gid ..., one word a token
    uint32_t w[4];
    if constexpr (PAIR) {
#pragma unroll
      for (int x2 = 0; x2 < 4; ++x2) {
        const int byte = c * 32 + 4 * gid + (x2 >> 1 ? shift1 : shift);
        w[x2] = keep_row[x2] && byte < ROW ? paged_cluster::v_word(pg, tok[x2], byte) : 0u;
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
}

constexpr int SCORE_SLOT = GMAX * PAGE * 4;   // a page's scores in a ring slot, at most

// Dynamic shared memory from a 1024-byte aligned base. Pass 1: each warp's
// ring of RING k pages. Pass 2: each warp's ring of RING slots of a v page
// and its scores; once every ring is drained, the warps' fp32 sums (CW x GM
// x DPC) over it.
template <int NT, typename TK>
__host__ __device__ constexpr int stats_bytes() {
  return warps<NT>() * RING * Pages<TK>::BYTES + 1024;
}
template <int NT, typename TK>
__host__ __device__ constexpr int values_bytes() {
  return (warps<NT>() * RING * (Pages<TK>::BYTES + SCORE_SLOT) >
                  warps<NT>() * NTILE * NT * DPC * 4
              ? warps<NT>() * RING * (Pages<TK>::BYTES + SCORE_SLOT)
              : warps<NT>() * NTILE * NT * DPC * 4) +
         1024;
}

// The pages of a cluster's share that block `rank` takes, as the one-launch
// cluster splits them: n pages of the share in its window from p_lo, per a
// block, n_act blocks with pages (rank 0 at least, with none where the
// share has no key that counts).
struct Share {
  int len, lo, begin, n_b, n_act;
  __device__ Share(const int* lens, int b, int max_blocks, int window, int C, int rank) {
    len = lens[b];
    lo = window_start(len, window);
    const int p_lo = lo / PAGE;
    const int n = max(0, pages_used(len, max_blocks) - p_lo);
    const int per = max(1, (n + C - 1) / C);
    n_act = max(1, (n + per - 1) / per);
    begin = p_lo + rank * per;
    n_b = max(0, min(per, n - rank * per));
  }
};

// Pass 1: one cluster per (batch row, kv head) (grid (C, KV, B), cluster
// dims (C, 1, 1)). q (B, KV, G, D) of TQ; the k pages through tk (flat: the
// (KV*D, 1, 16, P) map, its box at the 16-byte boundary at or before head
// kvh's row; PAIR: the paired map); lens counted from the share's first
// position; scores (B, KV, max_blocks, G, 16) fp32, written for the pages
// of the share in its window at their tokens (a key that does not count:
// NEG_INF); ml (B, KV, G, 2) fp32, the share's (m, l). NT n tiles of 8
// queries.
template <typename TK, typename TQ, int NT, bool PAIR = false>
__global__ void __launch_bounds__(warps<NT>() * 32)
paged_split_stats(const __grid_constant__ CUtensorMap tk, const TQ* __restrict__ q,
                  const int* __restrict__ tables, const int* __restrict__ lens,
                  float* __restrict__ scores, float* __restrict__ ml, int KV, int G, int D,
                  int max_blocks, int window, float scale, int flat) {
  using PG = Pages<TK>;
  constexpr int CW = warps<NT>();
  constexpr int GM = NTILE * NT;   // query rows, padded
  constexpr int KS = DPC / 16;     // k steps of q.k
  constexpr int QROW = DPC + 2;    // a row of qs: 65 words, so a warp's fragment loads hit 32 banks
  __shared__ __align__(16) uint16_t qs[GM][QROW];
  __shared__ float2 mlw[CW][GM];
  __shared__ float2 mlb[GM];       // the block's (m, l), read by block 0
  __shared__ __align__(8) uint64_t full[CW][RING];
  extern __shared__ uint8_t dsmem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dsmem) + 1023) & ~static_cast<uintptr_t>(1023));

  const uint32_t rank = hw::cluster_ctarank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const Share sh(lens, b, max_blocks, window, gridDim.x, (int)rank);
  if ((int)rank >= sh.n_act) return;
  const int n_w = sh.n_b > warp ? (sh.n_b - warp + CW - 1) / CW : 0;   // this warp's pages
  uint8_t* ring = base + warp * RING * PG::BYTES;
  const int nbox = (D * PG::EB + ROW - 1) / ROW;   // boxes a row fills
  const int shift = flat ? (kvh * D) & 15 : 0;     // the row's bytes into its box: 0 or 8
  const paged_cluster::Paired pr(kvh, KV, D);      // PAIR: each half's box and shift
  const int* mine = tables + (size_t)b * max_blocks + sh.begin + warp;   // page x: mine[CW * x]
  float* row_scores = scores + ((size_t)b * KV + kvh) * max_blocks * G * PAGE;

  int pid[2];   // the page ids of the warp's pages lane and lane + 32 (later ones: read at issue)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = lane + 32 * h;
    pid[h] = x < n_w ? mine[CW * x] : 0;
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
  // the warp's page x into its ring slot; every lane calls it, lane 0 issues
  auto issue = [&](int x) {
    const int page = x < 64 ? __shfl_sync(0xffffffffu, x < 32 ? pid[0] : pid[1], x & 31)
                            : mine[CW * x];
    if (lane == 0) {
      uint8_t* dst = ring + (x % RING) * PG::BYTES;
      uint64_t* bar = &full[warp][x % RING];
      hw::fence_proxy_async();   // the slot's earlier reads before the copy's writes
      hw::mbar_arrive_expect_tx(bar, nbox * BOX_BYTES);
      if constexpr (PAIR)
        pr.load(dst, &tk, bar, page);
      else
        for (int x2 = 0; x2 < nbox; ++x2)
          hw::tma_load_4d(dst + x2 * BOX_BYTES, &tk, bar,
                          (flat ? kvh * D - shift : 0) + x2 * (ROW / PG::EB), flat ? 0 : kvh, 0,
                          page);
    }
  };
  for (int x = 0; x < RING && x < n_w; ++x) issue(x);

  // q*scale rounded to the pages' dtype, in the operand type; query rows
  // G..GM-1 and head dims D..DPC-1 are zeros
  for (int i = tid; i < GM * DPC; i += CW * 32) {
    const int g = i / DPC, d = i % DPC;
    float x = 0.f;
    if (g < G && d < D)
      x = round_to<TK>(paged_cluster::to_f(q[(((size_t)b * KV + kvh) * G + g) * D + d]) * scale);
    qs[g][d] = paged_cluster::op_bits<TK>(x);
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
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[nt][e] = NEG_INF;
      l[nt][e] = 0.f;
    }
  for (int x = 0; x < n_w; ++x) {
    const int slot = x % RING;
    hw::mbar_wait(&full[warp][slot], (x / RING) & 1);
    const int j = sh.begin + warp + CW * x;
    const int n_valid = min(PAGE, sh.len + 1 - j * PAGE);   // tokens in the sequence
    const int n_skip = max(0, sh.lo - j * PAGE);            // tokens left of the window
    uint4 kr[2][PG::CHUNKS];
    if constexpr (PAIR) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        paged_cluster::k_row<TK>(kr[r], ring + slot * PG::BYTES + (rl + 8 * r) * ROW, rl, tig,
                                 pr.shift[r], D);
    } else {
      k_chunks<TK>(kr, ring + slot * PG::BYTES, rl, tig, shift, flat, D);
    }
    // S^T (16 tokens x 8 queries of each n tile) = K Q^T; sc[nt][r]: token
    // rl + 8*(r >> 1), query 8*nt + 2*tig + (r & 1)
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
    if (x + RING < n_w) issue(x + RING);   // the slot is free: its k is in registers

    // the tokens of slot rows rl and rl + 8 (PAIR: 2rl and 2rl + 1)
    const int t0 = PAIR ? 2 * rl : rl, t1 = PAIR ? 2 * rl + 1 : rl + 8;
    const bool v0 = t0 >= n_skip && t0 < n_valid;
    const bool v1 = t1 >= n_skip && t1 < n_valid;
    float* sp = row_scores + (size_t)j * G * PAGE;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int g = NTILE * nt + 2 * tig + e;
        const float s0 = v0 ? sc[nt][e] : NEG_INF, s1 = v1 ? sc[nt][2 + e] : NEG_INF;
        if (g < G) {   // the padded query rows' scores are not kept
          sp[g * PAGE + t0] = s0;
          sp[g * PAGE + t1] = s1;
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

  // ---- the warps' (m, l) -> the block's -> the share's, written by block 0
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
  if (rank == 0 && tid < G) {
    const uint32_t at = hw::smem_addr(&mlb[tid]);
    float2 mc[CLUSTER];
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c) {
      mc[c] = c < sh.n_act ? hw::ld_cluster_f32x2(hw::map_to_rank(at, c))
                           : make_float2(NEG_INF, 0.f);
      M = fmaxf(M, mc[c].x);
    }
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c)
      if (c < sh.n_act) L += mc[c].y * fast_exp(mc[c].x - M);
    reinterpret_cast<float2*>(ml)[((size_t)b * KV + kvh) * G + tid] = make_float2(M, L);
  }
  hw::cluster_sync();   // no block leaves while block 0 reads its shared memory
}

// Pass 2: one cluster per (batch row, kv head) (grid (C, KV, B)). The v
// pages through tv (as pass 1's tk, PAIR alike); scores pass 1's; mlg (B, KV, R, G, 2)
// fp32, the R shares' (m, l) in position order; lens as pass 1's; part (B,
// KV, G, D) fp32, the share's sum of the rounded weights times v (zeros
// where no key of the share counts). NT n tiles of 8 queries.
template <typename TK, int NT, bool PAIR = false>
__global__ void __launch_bounds__(warps<NT>() * 32)
paged_split_values(const __grid_constant__ CUtensorMap tv, const float* __restrict__ scores,
                   const float* __restrict__ mlg, int R, const int* __restrict__ tables,
                   const int* __restrict__ lens, float* __restrict__ part, int KV, int G, int D,
                   int max_blocks, int window, int flat) {
  using PG = Pages<TK>;
  constexpr int CW = warps<NT>();
  constexpr int GM = NTILE * NT;
  constexpr int KS = DPC / 16;     // m tiles of p.v
  constexpr int SLOT = PG::BYTES + SCORE_SLOT;   // a v page, then its scores
  __shared__ float Ms[GM], Ls[GM];
  __shared__ __align__(8) uint64_t full[CW][RING];
  extern __shared__ uint8_t dsmem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dsmem) + 1023) & ~static_cast<uintptr_t>(1023));

  const uint32_t rank = hw::cluster_ctarank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const Share sh(lens, b, max_blocks, window, gridDim.x, (int)rank);
  if ((int)rank >= sh.n_act) return;
  const int n_w = sh.n_b > warp ? (sh.n_b - warp + CW - 1) / CW : 0;
  uint8_t* ring = base + warp * RING * SLOT;
  const int nbox = (D * PG::EB + ROW - 1) / ROW;
  const int shift = flat ? (kvh * D) & 15 : 0;
  const paged_cluster::Paired pr(kvh, KV, D);
  const int score_bytes = G * PAGE * 4;
  const int* mine = tables + (size_t)b * max_blocks + sh.begin + warp;
  const float* row_scores = scores + ((size_t)b * KV + kvh) * max_blocks * G * PAGE;

  int pid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = lane + 32 * h;
    pid[h] = x < n_w ? mine[CW * x] : 0;
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < RING; ++s) hw::mbar_init(&full[warp][s], 1);
    hw::mbar_fence_init();
  }
  if (nbox < PG::NBOX)
    for (int i = lane * 16; i < RING * SLOT; i += 32 * 16)
      if (i % SLOT >= nbox * BOX_BYTES && i % SLOT < PG::BYTES)
        *reinterpret_cast<uint4*>(ring + i) = make_uint4(0, 0, 0, 0);
  __syncwarp();
  // the warp's page x, its v and its scores, into its ring slot
  auto issue = [&](int x) {
    const int page = x < 64 ? __shfl_sync(0xffffffffu, x < 32 ? pid[0] : pid[1], x & 31)
                            : mine[CW * x];
    if (lane == 0) {
      uint8_t* dst = ring + (x % RING) * SLOT;
      uint64_t* bar = &full[warp][x % RING];
      hw::fence_proxy_async();
      hw::mbar_arrive_expect_tx(bar, nbox * BOX_BYTES + score_bytes);
      if constexpr (PAIR)
        pr.load(dst, &tv, bar, page);
      else
        for (int x2 = 0; x2 < nbox; ++x2)
          hw::tma_load_4d(dst + x2 * BOX_BYTES, &tv, bar,
                          (flat ? kvh * D - shift : 0) + x2 * (ROW / PG::EB), flat ? 0 : kvh, 0,
                          page);
      hw::bulk_load(dst + PG::BYTES,
                    row_scores + (size_t)(sh.begin + warp + CW * x) * G * PAGE, score_bytes,
                    bar);
    }
  };
  for (int x = 0; x < RING && x < n_w; ++x) issue(x);

  // the sequence's (M, L) from the R shares' (m, l), in position order;
  // the padded query rows take (0, 1), so their NEG_INF scores weigh 0
  if (tid < GM) {
    float M = 0.f, L = 1.f;
    if (tid < G) {
      const float2* src = reinterpret_cast<const float2*>(mlg) +
                          ((size_t)b * KV + kvh) * R * G + tid;
      M = NEG_INF;
      L = 0.f;
      for (int r = 0; r < R; ++r) M = fmaxf(M, src[(size_t)r * G].x);
      for (int r = 0; r < R; ++r) L += src[(size_t)r * G].y * fast_exp(src[(size_t)r * G].x - M);
    }
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
  // the division by L as a product by 1/L, as the one-launch cluster's
  float Mq[NT], Linv[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    Mq[nt] = Ms[NTILE * nt + gid];
    Linv[nt] = 1.f / Ls[NTILE * nt + gid];
  }
  for (int x = 0; x < n_w; ++x) {
    const int slot = x % RING;
    hw::mbar_wait(&full[warp][slot], (x / RING) & 1);
    const int j = sh.begin + warp + CW * x;
    const int n_valid = min(PAGE, sh.len + 1 - j * PAGE);
    const int n_skip = max(0, sh.lo - j * PAGE);
    const uint8_t* pg = ring + slot * SLOT;
    uint32_t pb[NT][2];   // the page's rounded weights
    weights_b<TK, NT, PAIR>(pb, reinterpret_cast<const float*>(pg + PG::BYTES), G, gid, tig,
                            Mq, Linv);
    int tok[4];
    bool keep_row[4];
#pragma unroll
    for (int x2 = 0; x2 < 4; ++x2) {
      tok[x2] = 2 * tig + (x2 & 1) + 8 * (x2 >> 1);   // slot rows
      const int t = PAIR ? paged_cluster::paired_token(tok[x2]) : tok[x2];
      keep_row[x2] = t >= n_skip && t < n_valid;
    }
    if constexpr (PAIR)
      pv_page<TK, NT, true>(o, pg, pb, tok, keep_row, gid, pr.shift[0], pr.shift[1]);
    else
      pv_page<TK, NT>(o, pg, pb, tok, keep_row, gid, shift);
    __syncwarp();   // the slot's reads before it is written again
    if (x + RING < n_w) issue(x + RING);
  }

  // ---- the warps' sums, then the cluster's, into the share's partial
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
  const int total = G * D, share = (total + sh.n_act - 1) / sh.n_act;
  const int i_end = min(total, ((int)rank + 1) * share);
  for (int i = (int)rank * share + tid; i < i_end; i += CW * 32) {
    const int g = i / D, d = i % D;
    const uint32_t at = hw::smem_addr(accs + g * DPC + d);
    float sum[CLUSTER];   // every block's load in flight at once
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c)
      sum[c] = c < sh.n_act ? hw::ld_cluster_f32(hw::map_to_rank(at, c)) : 0.f;
    float A = 0.f;
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c) A += sum[c];
    part[((size_t)b * KV + kvh) * G * D + i] = A;
  }
  hw::cluster_sync();   // no block leaves while another reads its shared memory
}

// C of a pass over every (batch row, kv head) by paged_cluster's wave cost,
// a warp's chain being one page step for each of a block's pages; the
// opt-ins and the counts of clusters once per instance. 0 where the card
// holds no cluster of any size.
template <int NT, int SMEM>
int pass_clusters(const void* kernel, paged_cluster::ClusterLaunch& L, int B, int KV,
                  int span, bool& opted, int (&seen)[CLUSTER + 1], cudaError_t& e) {
  if (!opted) {
    if ((e = paged_cluster::opt_in(&kernel, 1, SMEM)) != cudaSuccess) return 0;
    opted = true;
  }
  const int C = paged_cluster::cluster_size<NT>(
      B, KV, span,
      [&](int c) {
        L.shape(c, SMEM);
        return paged_cluster::active_clusters(seen[c], kernel, L.cfg);
      },
      [&](int c) { return ((span + c - 1) / c + warps<NT>() - 1) / warps<NT>(); });
  if (C == 0) e = cudaErrorLaunchOutOfResources;
  else L.shape(C, SMEM);
  return C;
}

// Pass 1 over a share of every sequence (n_pages the pool's pages) through
// the instances of the map the pool takes; cudaErrorLaunchOutOfResources
// where the card holds no cluster.
template <typename TK, typename TQ, int NT>
cudaError_t launch_stats(const void* q, const void* kp, const void* tables, const void* lens,
                         float* scores, float* ml, int B, int KV, int G, int D, int max_blocks,
                         int window, float scale, int n_pages, cudaStream_t stream) {
  constexpr int SMEM = stats_bytes<NT, TK>();
  CUtensorMap tk, unused;
  int map = paged_cluster::PER_HEAD;
  cudaError_t e = paged_cluster::make_page_maps<TK>(&tk, &unused, kp, kp, KV, D, n_pages, &map);
  if (e != cudaSuccess) return e;
  return paged_cluster::with_map<TK>(map, [&](auto pair) -> cudaError_t {
    auto kernel = paged_split_stats<TK, TQ, NT, decltype(pair)::value>;
    static bool opted = false;
    static int seen[CLUSTER + 1];   // by C
    paged_cluster::ClusterLaunch L(warps<NT>() * 32, KV, B, stream);
    if (pass_clusters<NT, SMEM>((const void*)kernel, L, B, KV, span_pages(max_blocks, window),
                                opted, seen, e) == 0)
      return e;
    e = cudaLaunchKernelEx(&L.cfg, kernel, tk, static_cast<const TQ*>(q),
                           static_cast<const int*>(tables), static_cast<const int*>(lens),
                           scores, ml, KV, G, D, max_blocks, window, scale,
                           (int)(map != paged_cluster::PER_HEAD));
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
}

// Pass 2 over the same share, with the R shares' gathered (m, l).
template <typename TK, int NT>
cudaError_t launch_values(const void* vp, const float* scores, const float* mlg, int R,
                          const void* tables, const void* lens, float* part, int B, int KV, int G,
                          int D, int max_blocks, int window, int n_pages, cudaStream_t stream) {
  constexpr int SMEM = values_bytes<NT, TK>();
  CUtensorMap tv, unused;
  int map = paged_cluster::PER_HEAD;
  cudaError_t e = paged_cluster::make_page_maps<TK>(&tv, &unused, vp, vp, KV, D, n_pages, &map);
  if (e != cudaSuccess) return e;
  return paged_cluster::with_map<TK>(map, [&](auto pair) -> cudaError_t {
    auto kernel = paged_split_values<TK, NT, decltype(pair)::value>;
    static bool opted = false;
    static int seen[CLUSTER + 1];
    paged_cluster::ClusterLaunch L(warps<NT>() * 32, KV, B, stream);
    if (pass_clusters<NT, SMEM>((const void*)kernel, L, B, KV, span_pages(max_blocks, window),
                                opted, seen, e) == 0)
      return e;
    e = cudaLaunchKernelEx(&L.cfg, kernel, tv, scores, mlg, R, static_cast<const int*>(tables),
                           static_cast<const int*>(lens), part, KV, G, D, max_blocks, window,
                           (int)(map != paged_cluster::PER_HEAD));
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
}

}  // namespace paged_split_cluster
