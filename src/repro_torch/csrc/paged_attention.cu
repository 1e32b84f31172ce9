// Paged-attention decode for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: the Pallas TPU kernel paged_attention_kernel (body _paged_kernel)
// in src/repro/kernels/paged_attention/kernel.py.
//
// Computes one-token attention over a block-table-indexed paged KV pool.
// q (B,KV,G,D); k/v pages (P,16,KV,D); block_tables (B,max_blocks) int32
// page ids; lens[b] is the INCLUSIVE index of the newest token, so the
// sequence holds lens[b]+1 tokens; out (B,KV,G,D); fp32 or bf16. With
// window > 0 only the keys at lens[b] - window < pos <= lens[b] count (the
// JAX model's sliding-window decode_attention; the Pallas kernel has no
// window). G is 1..16; D is 32, 64, 80, 112, 120 or 128.
//
// Bound on this card: each cached token's k and v row is read once and used
// for only 2*G*D multiply-adds, a few operations per byte against the ~295
// the H100 needs to leave the memory roof, so it is bound by HBM bytes:
// about sum_b (lens[b]+1)*KV*D*2*sizeof(elem) per layer. Reaching that
// bound takes many bytes in flight on every SM and few instructions per
// byte.
//
// Design: split over the sequence. The split kernel runs one block per
// (partition of 16 pages = 256 tokens, kv head, batch); a block whose
// partition starts past ceil((lens[b]+1)/16), or ends at or left of the
// window's edge lens[b] - window, exits at once; the partition that
// straddles the edge starts at the edge's page and masks the tokens left
// of it, and the merge reads only the partitions inside the window. The block
// computes all G query rows of its kv head, so each page is read from
// device memory once for the G queries (GQA's saving in a bytes-bound
// kernel). Its four warps take the partition's pages in turn (warp w:
// pages w, w+4, ...), each through its own 2-slot cp.async ring in shared
// memory, so every warp has the next page's k and v in flight while it
// computes the current one. The warps' (m, l, acc) merge in shared memory
// and the block writes its partition's fp32 partial (m, l, acc[G][D]);
// paged_merge then combines the partitions of each (batch, kv head) into
// out. Two more entries expose the halves: paged_attention_partials runs the
// split kernel alone and leaves the partials to the caller, and
// paged_merge_fwd merges any number of partitions. A decode whose cache
// sequence is cut over ranks runs the first on each rank's share, gathers
// the partials and merges them once. Softmax state is fp32; q*scale and
// the softmax weights are rounded to the pool dtype before the products, as
// the TPU kernel's are.
//
// Head dims 80, 112 and 120 (rows of 160, 224 and 240 bytes in bf16,
// whole 16-byte chunks) take the 128 instance's shared-memory geometry
// (a row of whole 8-chunk swizzle groups): cp.async copies only a row's
// D*sizeof(T) bytes, the pad chunks of every ring slot and the pad of q
// are zeroed once, so they add nothing to q.k or p.v, and only D outputs
// are written. The scale is the real D's.
//
// The page's products, by dtype (each dtype has one route):
// - bf16, paged_split_mma: tensor cores, mma.sync m16n8k16. Scores are
//   computed transposed, S^T = K Q^T, so the page's 16 tokens are the M
//   rows and the queries of the group the N columns of one n8 tile (G <= 8)
//   or two (G 9..16; each k fragment then feeds two products).
//   K and V rows land in shared memory with their 16-byte chunks
//   XOR-swizzled by token, so ldmatrix reads them without bank conflicts;
//   V is read transposed for O^T += V^T P^T, with P passed through shared
//   memory. A thread holds the scores, softmax state and outputs of the
//   same two queries of each n tile throughout.
// - fp32, paged_split_simt: fp32 FMAs. Lane (t, half) dots token t's k
//   with the G queries over one half of the head dim, and for p.v each lane
//   owns D/32 contiguous head-dim elements.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "paged_common.cuh"

namespace {

using namespace repro_torch;
using namespace repro_torch::paged;
namespace hw = repro_torch::hopper;

constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int D>
struct PagedGeom {
  // head dim in shared memory: 32, 64 or 128, so that a row past 128
  // bytes is whole groups of the 8-chunk swizzle
  static constexpr int DP = D <= 32 ? 32 : D <= 64 ? 64 : 128;
  static constexpr int ROW = DP * (int)sizeof(T);    // bytes of a token's k (or v) row
  static constexpr int CHUNKS = ROW / 16;            // 16-byte chunks per row
  static constexpr int CHUNKS_D = D * (int)sizeof(T) / 16;  // chunks copied from the pool
  static constexpr int SWZ = CHUNKS < 8 ? CHUNKS - 1 : 7;  // chunk swizzle mask
  static constexpr int PAGE_BYTES = PAGE * ROW;      // k (or v) of one page and kv head
  static constexpr int RING = WARPS * STAGES * 2 * PAGE_BYTES;
  static_assert(D * sizeof(T) % 16 == 0, "a row must be whole 16-byte chunks");
  static_assert(D <= 128, "the widest geometry is 128");
};

// Zeroes the pad chunks (head dims D..DP-1) of k and v in every slot of one
// warp's ring, where cp.async never writes, so they add nothing to q.k and
// p.v; k's chunks are swizzled, v's where `swizzle_v` says so.
template <typename T, int D>
__device__ __forceinline__ void zero_pads(uint8_t* ring, int lane, bool swizzle_v) {
  using P = PagedGeom<T, D>;
  constexpr int NP = P::CHUNKS - P::CHUNKS_D;
  if constexpr (NP > 0) {
    for (int i = lane; i < STAGES * PAGE * NP; i += 32) {
      const int slot = i / (PAGE * NP), tok = i / NP % PAGE, ch = P::CHUNKS_D + i % NP;
      uint8_t* ks = ring + slot * 2 * P::PAGE_BYTES + tok * P::ROW;
      const int sw = ch ^ (tok & P::SWZ);
      *reinterpret_cast<uint4*>(ks + sw * 16) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(ks + P::PAGE_BYTES + (swizzle_v ? sw : ch) * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
}

// Issues one warp's cp.async copies of a page's k and v rows of one kv head
// into a ring slot (k at ks, v right after), chunk c of token t at chunk
// c ^ (t & SWZ) where `swizzle` says so, and commits them as one group.
template <typename T, int D>
__device__ __forceinline__ void load_page(uint8_t* ks, const T* k_pages, const T* v_pages,
                                          size_t page_base, size_t tok_stride, int lane,
                                          bool swizzle_v) {
  using P = PagedGeom<T, D>;
  constexpr int CH = 16 / (int)sizeof(T);
  uint8_t* vs = ks + P::PAGE_BYTES;
#pragma unroll
  for (int c = lane; c < PAGE * P::CHUNKS_D; c += 32) {
    const int tok = c / P::CHUNKS_D, ch = c % P::CHUNKS_D;
    const size_t src = page_base + tok * tok_stride + ch * CH;
    const int sw = (ch ^ (tok & P::SWZ)) * 16;
    hw::cp_async_16(ks + tok * P::ROW + sw, k_pages + src);
    hw::cp_async_16(vs + tok * P::ROW + (swizzle_v ? sw : ch * 16), v_pages + src);
  }
  hw::cp_async_commit();
}

// Zeroes v's rows of the tokens of a ring slot that do not count (before
// n_skip: left of the window; from n_valid: past the sequence), whose p is
// 0 but whose bytes may not be finite.
template <typename T, int D>
__device__ __forceinline__ void zero_v_rows(uint8_t* vs, int n_skip, int n_valid, int lane) {
  using P = PagedGeom<T, D>;
  uint4* rows = reinterpret_cast<uint4*>(vs);
  for (int c = lane; c < n_skip * P::CHUNKS; c += 32) rows[c] = make_uint4(0, 0, 0, 0);
  for (int c = n_valid * P::CHUNKS + lane; c < PAGE * P::CHUNKS; c += 32)
    rows[c] = make_uint4(0, 0, 0, 0);
}

// Merges the four warps' (ms, ls, accs[w][g][d]) and writes the block's
// partial: part_acc[pidx][g][d] and part_ml[pidx][g] = (m, l).
template <int D, int DP, int GM>
__device__ __forceinline__ void write_partial(const float (&ms)[WARPS][GM],
                                              const float (&ls)[WARPS][GM],
                                              const float* accs, int G, size_t pidx,
                                              float* part_acc, float* part_ml) {
  for (int i = threadIdx.x; i < G * D; i += WARPS * 32) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, ms[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(ms[w][g] - M);
      L += ls[w][g] * f;
      A += accs[(w * GM + g) * DP + d] * f;
    }
    part_acc[pidx * G * D + i] = A;
    if (d == 0) {
      part_ml[(pidx * G + g) * 2] = M;
      part_ml[(pidx * G + g) * 2 + 1] = L;
    }
  }
}

// ------------------------------------------------------- bf16: tensor cores
// NT n tiles of 8 queries: G <= 8 * NT.
template <int D, int NT>
__global__ void __launch_bounds__(WARPS * 32)
paged_split_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
                const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ tables,
                const int* __restrict__ lens, float* __restrict__ part_acc,
                float* __restrict__ part_ml, int KV, int G, int max_blocks, int n_part,
                int window, float scale) {
  using P = PagedGeom<__nv_bfloat16, D>;
  constexpr int DP = P::DP;
  constexpr int KS = DP / 16;  // k-steps of q.k, m-tiles of p.v
  constexpr int GM = NTILE * NT;
  static_assert(WARPS * GM * DP * 4 <= P::RING, "the warps' acc must fit in the ring");
  __shared__ __align__(16) __nv_bfloat16 qs[GM][DP];
  __shared__ __align__(16) __nv_bfloat16 pw[WARPS][GM][PAGE];
  __shared__ float ms[WARPS][GM];
  __shared__ float ls[WARPS][GM];
  extern __shared__ __align__(128) uint8_t ring[];  // the warps' rings, then their acc

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const Partition pt = partition_of(lens, b, max_blocks, window);
  if (pt.n_pages <= 0) return;  // the whole block: past the pages or left of the window

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;   // mma row group
  const int tig = lane & 3;    // thread in group: queries 2*tig, 2*tig + 1 of each n tile
  const size_t q_off = ((size_t)b * KV + kvh) * G * D;
  const size_t tok_stride = (size_t)KV * D;

  const int n_mine = pt.n_pages > warp ? (pt.n_pages - warp + WARPS - 1) / WARPS : 0;
  uint8_t* my_ring = ring + warp * STAGES * 2 * P::PAGE_BYTES;
  auto issue = [&](int i) {
    const int pg = pt.page0 + warp + WARPS * i;
    const size_t page_base =
        (size_t)tables[(size_t)b * max_blocks + pg] * PAGE * tok_stride + (size_t)kvh * D;
    load_page<__nv_bfloat16, D>(my_ring + (i % STAGES) * 2 * P::PAGE_BYTES, k_pages, v_pages,
                                page_base, tok_stride, lane, true);
  };
  zero_pads<__nv_bfloat16, D>(my_ring, lane, true);
  if (n_mine > 0) issue(0);
  if (n_mine > 1) issue(1);

  // q*scale rounded to bf16; query rows G..GM-1 and head dims D..DP-1 are zeros
  for (int i = tid; i < GM * DP; i += WARPS * 32) {
    const int g = i / DP, d = i % DP;
    qs[g][d] = __float2bfloat16(
        g < G && d < D ? __bfloat162float(q[q_off + g * D + d]) * scale : 0.f);
  }
  __syncthreads();
  // Q^T as the B operand of every k-step: column gid of n tile nt is query 8*nt + gid
  uint32_t qb[NT][KS][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qb[nt][kk][0] = *reinterpret_cast<const uint32_t*>(&qs[NTILE * nt + gid][16 * kk + 2 * tig]);
      qb[nt][kk][1] =
          *reinterpret_cast<const uint32_t*>(&qs[NTILE * nt + gid][16 * kk + 8 + 2 * tig]);
    }

  // o[nt][mt][r]: head dim 16*mt + gid + 8*(r >> 1), query 8*nt + 2*tig + (r & 1)
  float o[NT][KS][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[nt][mt][r] = 0.f;
  float m[NT][2], l[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[nt][e] = NEG_INF;
      l[nt][e] = 0.f;
    }
  // ldmatrix row addresses: lane gives row lane % 8 of matrix lane / 8
  const int mi = lane >> 3;
  const int k_tok = (lane & 7) + 8 * (mi & 1);   // K: matrices (tokens 0-7 | 8-15) x chunk
  const int v_tok = (lane & 7) + 8 * (mi >> 1);  // V^T: matrices chunk x (tokens 0-7 | 8-15)

  for (int i = 0; i < n_mine; ++i) {
    if (i + 1 < n_mine) hw::cp_async_wait<1>(); else hw::cp_async_wait<0>();
    __syncwarp();  // every lane's copies of page i have landed
    const int j = pt.page0 + warp + WARPS * i;  // page index in the sequence
    uint8_t* ks = my_ring + (i % STAGES) * 2 * P::PAGE_BYTES;
    uint8_t* vs = ks + P::PAGE_BYTES;
    const int n_valid = min(PAGE, pt.seq_len - j * PAGE);  // tokens in the sequence
    const int n_skip = max(0, pt.lo - j * PAGE);           // tokens left of the window
    if (n_valid < PAGE || n_skip > 0) {  // an edge page: zero v where p is 0
      zero_v_rows<__nv_bfloat16, D>(vs, n_skip, n_valid, lane);
      __syncwarp();
    }

    // S^T (16 tokens x 8 queries of each n tile) = K Q^T; sc[nt][r]: token
    // gid + 8*(r >> 1), query 8*nt + 2*tig + (r & 1)
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nt][r] = 0.f;
    const uint32_t k_row = hw::smem_addr(ks) + k_tok * P::ROW;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int ch = 2 * kk + (mi >> 1);
      uint32_t a[4];
      hw::ldmatrix_x4(a, k_row + ((ch ^ (k_tok & P::SWZ)) << 4));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) hw::mma_16816(sc[nt], a, qb[nt][kk]);
    }

    const bool valid0 = gid >= n_skip && gid < n_valid;
    const bool valid1 = gid + 8 >= n_skip && gid + 8 < n_valid;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a query's 16 scores lie in the 8 lanes of one tig, two each
        float mx = fmaxf(valid0 ? sc[nt][e] : NEG_INF, valid1 ? sc[nt][2 + e] : NEG_INF);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[nt][e], mx);
        const float alpha = exp2f((m[nt][e] - m_new) * LOG2E);
        const float p0 = valid0 ? exp2f((sc[nt][e] - m_new) * LOG2E) : 0.f;
        const float p1 = valid1 ? exp2f((sc[nt][2 + e] - m_new) * LOG2E) : 0.f;
        float rs = p0 + p1;
        rs += __shfl_xor_sync(0xffffffffu, rs, 4);
        rs += __shfl_xor_sync(0xffffffffu, rs, 8);
        rs += __shfl_xor_sync(0xffffffffu, rs, 16);
        l[nt][e] = l[nt][e] * alpha + rs;
        m[nt][e] = m_new;
#pragma unroll
        for (int mt = 0; mt < KS; ++mt) {
          o[nt][mt][e] *= alpha;
          o[nt][mt][2 + e] *= alpha;
        }
        pw[warp][NTILE * nt + 2 * tig + e][gid] = __float2bfloat16(p0);
        pw[warp][NTILE * nt + 2 * tig + e][gid + 8] = __float2bfloat16(p1);
      }
    __syncwarp();
    // P^T as the B operand: column gid of n tile nt is query 8*nt + gid, rows are tokens
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      pb[nt][0] = *reinterpret_cast<const uint32_t*>(&pw[warp][NTILE * nt + gid][2 * tig]);
      pb[nt][1] = *reinterpret_cast<const uint32_t*>(&pw[warp][NTILE * nt + gid][8 + 2 * tig]);
    }

    // O^T (DP x 8 queries of each n tile) += V^T P^T, 16 head dims at a time
    const uint32_t v_row = hw::smem_addr(vs) + v_tok * P::ROW;
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      const int ch = 2 * mt + (mi & 1);
      uint32_t a[4];
      hw::ldmatrix_x4_trans(a, v_row + ((ch ^ (v_tok & P::SWZ)) << 4));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) hw::mma_16816(o[nt][mt], a, pb[nt]);
    }
    __syncwarp();  // pw and this ring slot are rewritten next
    if (i + 2 < n_mine) issue(i + 2);
  }

  __syncthreads();  // every warp is done with its ring: it now holds the accs
  float* accs = reinterpret_cast<float*>(ring);  // [WARPS][GM][DP]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int g = NTILE * nt + 2 * tig + e;
      if (gid == 0) {
        ms[warp][g] = m[nt][e];
        ls[warp][g] = l[nt][e];
      }
#pragma unroll
      for (int mt = 0; mt < KS; ++mt) {
        accs[(warp * GM + g) * DP + 16 * mt + gid] = o[nt][mt][e];
        accs[(warp * GM + g) * DP + 16 * mt + gid + 8] = o[nt][mt][2 + e];
      }
    }
  __syncthreads();
  write_partial<D, DP, GM>(ms, ls, accs, G, ((size_t)b * KV + kvh) * n_part + blockIdx.x,
                           part_acc, part_ml);
}

// --------------------------------------------------------------- fp32: SIMT
// G <= 8 * NT query rows.
template <int D, int NT>
__global__ void __launch_bounds__(WARPS * 32)
paged_split_simt(const float* __restrict__ q, const float* __restrict__ k_pages,
                 const float* __restrict__ v_pages, const int* __restrict__ tables,
                 const int* __restrict__ lens, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int KV, int G, int max_blocks, int n_part,
                 int window, float scale) {
  using P = PagedGeom<float, D>;
  constexpr int DP = P::DP;
  constexpr int E = DP / 32;    // p.v elements per lane
  constexpr int HALF = DP / 2;  // q.k elements per lane
  constexpr int CH = 4;         // fp32 elements per 16-byte chunk
  constexpr int GM = NTILE * NT;
  static_assert(WARPS * GM * DP * 4 <= P::RING, "the warps' acc must fit in the ring");
  __shared__ __align__(16) float qs[GM][DP];
  __shared__ __align__(16) float ps[WARPS][GM][PAGE];
  __shared__ float ms[WARPS][GM];
  __shared__ float ls[WARPS][GM];
  extern __shared__ __align__(128) uint8_t ring[];  // the warps' rings, then their acc

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const Partition pt = partition_of(lens, b, max_blocks, window);
  if (pt.n_pages <= 0) return;  // the whole block: past the pages or left of the window

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 15;
  const int half = lane >> 4;
  const size_t q_off = ((size_t)b * KV + kvh) * G * D;
  const size_t tok_stride = (size_t)KV * D;

  const int n_mine = pt.n_pages > warp ? (pt.n_pages - warp + WARPS - 1) / WARPS : 0;
  uint8_t* my_ring = ring + warp * STAGES * 2 * P::PAGE_BYTES;
  auto issue = [&](int i) {
    const int pg = pt.page0 + warp + WARPS * i;
    const size_t page_base =
        (size_t)tables[(size_t)b * max_blocks + pg] * PAGE * tok_stride + (size_t)kvh * D;
    load_page<float, D>(my_ring + (i % STAGES) * 2 * P::PAGE_BYTES, k_pages, v_pages,
                        page_base, tok_stride, lane, false);
  };
  zero_pads<float, D>(my_ring, lane, false);
  if (n_mine > 0) issue(0);
  if (n_mine > 1) issue(1);

  for (int i = tid; i < GM * DP; i += WARPS * 32) {
    const int g = i / DP, d = i % DP;
    qs[g][d] = g < G && d < D ? q[q_off + g * D + d] * scale : 0.f;
  }
  __syncthreads();

  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < n_mine; ++i) {
    if (i + 1 < n_mine) hw::cp_async_wait<1>(); else hw::cp_async_wait<0>();
    __syncwarp();  // every lane's copies of page i have landed
    const int j = pt.page0 + warp + WARPS * i;  // page index in the sequence
    const uint8_t* ks = my_ring + (i % STAGES) * 2 * P::PAGE_BYTES;
    const float* krow = reinterpret_cast<const float*>(ks + t * P::ROW);
    const float* qh = &qs[0][half * HALF];  // a broadcast within each half
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
#pragma unroll
    for (int c = 0; c < HALF; c += CH) {
      const int ch = (half * HALF + c) / CH;
      const float4 k4 = *reinterpret_cast<const float4*>(krow + (ch ^ (t & P::SWZ)) * CH);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float4 q4 = *reinterpret_cast<const float4*>(qh + g * DP + c);
          s[g] = fmaf(q4.x, k4.x, s[g]);
          s[g] = fmaf(q4.y, k4.y, s[g]);
          s[g] = fmaf(q4.z, k4.z, s[g]);
          s[g] = fmaf(q4.w, k4.w, s[g]);
        }
      }
    }

    const int n_valid = min(PAGE, pt.seq_len - j * PAGE);  // tokens in the sequence
    const int n_skip = max(0, pt.lo - j * PAGE);           // tokens left of the window
    const bool valid = t >= n_skip && t < n_valid;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
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
        if (half == 0) ps[warp][g][t] = p;
      }
    }
    __syncwarp();

    const float* vrow = reinterpret_cast<const float*>(ks + P::PAGE_BYTES) + lane * E;
#pragma unroll 4
    for (int tt = 0; tt < PAGE; ++tt) {
      if (tt >= n_skip && tt < n_valid) {
        float vf[E];
        load_f<E>(vrow + tt * DP, vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float p = ps[warp][g][tt];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
          }
        }
      }
    }
    __syncwarp();  // ps and this ring slot are rewritten next
    if (i + 2 < n_mine) issue(i + 2);
  }

  __syncthreads();  // every warp is done with its ring: it now holds the accs
  float* accs = reinterpret_cast<float*>(ring);  // [WARPS][GM][DP]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      if (lane == 0) {
        ms[warp][g] = m[g];
        ls[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) accs[(warp * GM + g) * DP + lane * E + e] = acc[g][e];
    }
  }
  __syncthreads();
  write_partial<D, DP, GM>(ms, ls, accs, G, ((size_t)b * KV + kvh) * n_part + blockIdx.x,
                           part_acc, part_ml);
}

// Combines the partitions of one (kv head, batch) that the split kernel
// wrote (those inside the window): out = sum_p acc_p e^(m_p - M) /
// sum_p l_p e^(m_p - M) with M the largest m_p. Without lens (the merge
// entry) it combines all n_part partitions: partitions that no split block
// wrote hold (m, l, acc) = (NEG_INF, 0, 0), set by the caller, and add
// nothing.
template <typename T, int D>
__global__ void __launch_bounds__(128)
paged_merge(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
            const int* __restrict__ lens, T* __restrict__ out, int KV, int G,
            int max_blocks, int n_part, int window) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int np = lens ? (pages_used(lens[b], max_blocks) + PART - 1) / PART : n_part;
  const int p_first = lens ? window_start(lens[b], window) / PAGE / PART : 0;
  const size_t p0 = ((size_t)b * KV + kvh) * n_part;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    float M = NEG_INF;
#pragma unroll 4
    for (int p = p_first; p < np; ++p) M = fmaxf(M, part_ml[((p0 + p) * G + g) * 2]);
    float L = 0.f, A = 0.f;
#pragma unroll 4
    for (int p = p_first; p < np; ++p) {
      const float f = expf(part_ml[((p0 + p) * G + g) * 2] - M);
      L += part_ml[((p0 + p) * G + g) * 2 + 1] * f;
      A += part_acc[(p0 + p) * G * D + i] * f;
    }
    out[((size_t)b * KV + kvh) * G * D + i] = from_f<T>(L > 0.f ? A / L : 0.f);
  }
}

// The split kernel over every partition of the table: each writes its
// partial (m, l, acc) into part_ml / part_acc, (B, KV, n_part, G, 2 | D).
template <typename T, int D, int NT>
cudaError_t launch_split(const void* q, const void* kp, const void* vp, const void* tables,
                         const void* lens, float* part_acc, float* part_ml, int B, int KV,
                         int G, int max_blocks, int window, float scale,
                         cudaStream_t stream) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int RING = PagedGeom<T, D>::RING;
  const auto split = BF16 ? (void*)paged_split_mma<D, NT> : (void*)paged_split_simt<D, NT>;
  static bool attr_set = false;  // the opt-in above 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize, RING);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_part = (max_blocks + PART - 1) / PART;
  const dim3 grid(n_part, KV, B);
  if constexpr (BF16)
    paged_split_mma<D, NT><<<grid, WARPS * 32, RING, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
        static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(tables),
        static_cast<const int*>(lens), part_acc, part_ml, KV, G, max_blocks, n_part, window,
        scale);
  else
    paged_split_simt<D, NT><<<grid, WARPS * 32, RING, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(kp),
        static_cast<const float*>(vp), static_cast<const int*>(tables),
        static_cast<const int*>(lens), part_acc, part_ml, KV, G, max_blocks, n_part, window,
        scale);
  return cudaGetLastError();
}

// Calls f with the dtype's storage type and the head dim as
// std::integral_constant values; an unknown one is cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(int dtype, int D, F&& f) {
  auto with_d = [&](auto t) -> cudaError_t {
    switch (D) {
      case 32: return f(t, std::integral_constant<int, 32>{});
      case 64: return f(t, std::integral_constant<int, 64>{});
      case 80: return f(t, std::integral_constant<int, 80>{});
      case 112: return f(t, std::integral_constant<int, 112>{});
      case 120: return f(t, std::integral_constant<int, 120>{});
      case 128: return f(t, std::integral_constant<int, 128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return with_d(float{});
  if (dtype == 1) return with_d(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32 (SIMT split kernel), 1 = bf16 (tensor-core split kernel).
// window <= 0: no window. scratch holds B*KV*ceil(max_blocks/16)*G*(D+2)
// fp32 values (the partitions' acc, then their (m, l)). Returns
// cudaGetLastError() after the merge launch (or after the split launch, if
// that failed).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lens, void* out, void* scratch,
                                   int B, int KV, int G, int D, int max_blocks,
                                   int window, float scale, int dtype, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (G < 1 || G > GMAX || max_blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto t, auto d) -> cudaError_t {
    using T = decltype(t);
    constexpr int DD = decltype(d)::value;
    const int n_part = (max_blocks + PART - 1) / PART;
    float* part_acc = static_cast<float*>(scratch);
    float* part_ml = part_acc + (size_t)B * KV * n_part * G * DD;
    const cudaError_t e =
        G <= NTILE ? launch_split<T, DD, 1>(q, k_pages, v_pages, tables, lens, part_acc, part_ml,
                                            B, KV, G, max_blocks, window, scale, s)
                   : launch_split<T, DD, 2>(q, k_pages, v_pages, tables, lens, part_acc, part_ml,
                                            B, KV, G, max_blocks, window, scale, s);
    if (e != cudaSuccess) return e;
    paged_merge<T, DD><<<dim3(KV, B), 128, 0, s>>>(part_acc, part_ml,
                                                   static_cast<const int*>(lens),
                                                   static_cast<T*>(out), KV, G, max_blocks,
                                                   n_part, window);
    return cudaGetLastError();
  });
}

// The split kernel alone: each partition's fp32 partial into part_acc
// (B, KV, ceil(max_blocks/16), G, D) and part_ml (..., G, 2) = (m, l). A
// partition that no block writes (past the sequence, left of the window)
// keeps what the caller put there. lens[b] is the newest token's index
// counted from the table's first position, and may lie outside the table:
// past its end every token of the table counts, before its start none
// does; the window is applied to the same positions. Returns
// cudaGetLastError() after the launch.
extern "C" int paged_attention_partials(const void* q, const void* k_pages,
                                        const void* v_pages, const void* tables,
                                        const void* lens, void* part_acc, void* part_ml,
                                        int B, int KV, int G, int D, int max_blocks,
                                        int window, float scale, int dtype, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (G < 1 || G > GMAX || max_blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto t, auto d) -> cudaError_t {
    using T = decltype(t);
    constexpr int DD = decltype(d)::value;
    float* acc = static_cast<float*>(part_acc);
    float* ml = static_cast<float*>(part_ml);
    return G <= NTILE ? launch_split<T, DD, 1>(q, k_pages, v_pages, tables, lens, acc, ml, B,
                                               KV, G, max_blocks, window, scale, s)
                      : launch_split<T, DD, 2>(q, k_pages, v_pages, tables, lens, acc, ml, B,
                                               KV, G, max_blocks, window, scale, s);
  });
}

// The merge alone, over all n_part partitions of each (batch, kv head):
// part_acc (B, KV, n_part, G, D) and part_ml (B, KV, n_part, G, 2) fp32,
// out (B, KV, G, D) of dtype. Returns cudaGetLastError() after the launch.
extern "C" int paged_merge_fwd(const void* part_acc, const void* part_ml, void* out, int B,
                               int KV, int G, int D, int n_part, int dtype, void* stream) {
  if (B == 0 || KV == 0) return 0;
  if (G < 1 || n_part < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto t, auto d) -> cudaError_t {
    using T = decltype(t);
    constexpr int DD = decltype(d)::value;
    paged_merge<T, DD><<<dim3(KV, B), 128, 0, s>>>(
        static_cast<const float*>(part_acc), static_cast<const float*>(part_ml), nullptr,
        static_cast<T*>(out), KV, G, n_part * PART, n_part, 0);
    return cudaGetLastError();
  });
}
