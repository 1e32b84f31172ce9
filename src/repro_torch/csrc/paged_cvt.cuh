// Paged-attention decode over pages of another dtype than q (a cache of the
// reference's kv_cache_dtype) read upcast to q's dtype: the split kernel of
// paged_attention.cu with its pages converted to bf16 in shared memory
// (ONEPASS), its merge (cvt_merge), and the sum of the split decode's
// partials (part_sum). Included by paged_cluster.cuh (its rounding helpers
// and part_sum, through paged_attention_cvt.cu) and paged_attention_upcast.cu
// (the cache upcast to q's dtype, one pass; fp32 pages under a bf16 q too,
// each page rounded to bf16 on load as the reference's upcast rounds it).
//
// Replaces: the Pallas TPU kernel paged_attention_kernel (body
// _paged_kernel, src/repro/kernels/paged_attention/kernel.py:79) for an
// fp32 q over fp8 e4m3, int8 or bf16 pages, and fp32 pages under a bf16 q,
// under the reference's decode_unroll (which upcasts the cache to q's dtype
// before decode_attention), and for the split half of that mode under
// seq_shard_decode. The reference's main path calls the model's
// decode_attention (src/repro/models/attention.py:102-124), not the Pallas
// kernel, and the two differ once pages are quantised: both round q*scale
// to the pages' dtype, but decode_attention rounds the NORMALISED weights
// exp(s - M)/L to it (M, L the row's global max and sum), the Pallas kernel
// the running exp(s - m). For e4m3 the normalised weights of a long context
// fall into its subnormals; for int8 they truncate to 0. The port computes
// decode_attention's function (the default mode: paged_cluster.cuh) and,
// under decode_unroll, the upcast cache's.
//
// ONEPASS: the same-dtype kernels' online softmax, (m, l, acc) a
// partition, cvt_merge into out; q*scale and the running weights are
// rounded to q's dtype: bf16 when q is, else kept as NS = 3 bf16 terms
// whose sum is the fp32 value. Every operand of a product is exact in
// bf16: e4m3 and int8 values (and bf16's), each bf16 term of an fp32
// value. So the products run on the bf16 tensor cores (mma.sync m16n8k16,
// the layout of paged_split_mma) with fp32 sums, and only the sums' order
// differs from the reference's fp32 products.
//
// Bound on this card: as paged_attention.cu, HBM bytes, here the pages'
// bytes an element. Design: each warp's pages come through its own 2-slot
// cp.async ring of raw pool bytes (8 elements a copy: 8 bytes, or 16 for
// bf16 pages, 32 for fp32); the warp converts a page into a bf16 tile
// (token rows of DP elements, 16-byte chunks XOR-swizzled by token, as
// paged_split_mma's ring), zeroing the rows of tokens that do not count,
// and reissues the freed slot before it computes. Head dims take the
// geometry DP of 32, 64 or 128 with D a run-time argument (pads zeroed
// once), which keeps the instances few.
#pragma once

#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "paged_common.cuh"

namespace paged_cvt {

using namespace repro_torch;
using namespace repro_torch::paged;
namespace hw = repro_torch::hopper;

constexpr float E4M3_NAN_FROM = 464.f;  // |x| above this rounds past 448: NaN

struct E4M3 {  // an fp8 e4m3 pool element
  uint8_t bits;
};

// page dtype codes of the C entries (kernels/build.py PAGE_CODES)
constexpr int PAGE_BF16 = 1, PAGE_E4M3 = 2, PAGE_INT8 = 3, PAGE_F32 = 4;

// x rounded to the pages' dtype as jnp.astype rounds, returned as the fp32
// value (exact in bf16): e4m3 to nearest even with NaN past 464 (ml_dtypes;
// cvt.rn.satfinite gives 448 for (448, 464]), int8 saturated and truncated
// toward zero with NaN -> 0.
template <typename TK> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<E4M3>(float x) {
  if (!(fabsf(x) <= E4M3_NAN_FROM)) return __int_as_float(0x7fc00000);
  const __nv_fp8_storage_t r = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(r, __NV_E4M3)));
}
template <> __device__ __forceinline__ float round_to<int8_t>(float x) {
  if (x != x) return 0.f;
  return truncf(fminf(fmaxf(x, -128.f), 127.f));
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&r);
}

// 8 pool elements (one unit of the staging ring) as 8 bf16 (16 bytes).
template <typename TK> __device__ __forceinline__ uint4 unit_bf16(const uint8_t* src);
template <> __device__ __forceinline__ uint4 unit_bf16<__nv_bfloat16>(const uint8_t* src) {
  return *reinterpret_cast<const uint4*>(src);
}
template <> __device__ __forceinline__ uint4 unit_bf16<int8_t>(const uint8_t* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  return make_uint4(pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]), pack_bf16(e[4], e[5]),
                    pack_bf16(e[6], e[7]));
}
template <> __device__ __forceinline__ uint4 unit_bf16<float>(const uint8_t* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 16);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                    pack_bf16(b.z, b.w));
}
template <> __device__ __forceinline__ uint4 unit_bf16<E4M3>(const uint8_t* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = i < 2 ? raw.x : raw.y;
    const __nv_fp8x2_storage_t pair =
        static_cast<__nv_fp8x2_storage_t>((word >> (16 * (i & 1))) & 0xffffu);
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
    w[i] = pack_bf16(f.x, f.y);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One unit from global to shared memory: 32 bytes (fp32 pages) or 16 (bf16
// pages) bypassing L1, or 8 (8-bit pages).
template <int BYTES> __device__ __forceinline__ void cp_async_unit(void* dst, const void* src) {
  if constexpr (BYTES == 32) {
    hw::cp_async_16(dst, src);
    hw::cp_async_16(static_cast<uint8_t*>(dst) + 16, static_cast<const uint8_t*>(src) + 16);
  } else if constexpr (BYTES == 16) {
    hw::cp_async_16(dst, src);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(hw::smem_addr(dst)), "l"(src) : "memory");
  }
}

template <typename TK, int DP>
struct Geom {
  static constexpr int UNIT = 8 * (int)sizeof(TK);       // bytes of 8 pool elements
  static constexpr int RAW_ROW = DP * (int)sizeof(TK);   // a token's row in the staging ring
  static constexpr int RAW_PAGE = PAGE * RAW_ROW;        // k (or v) of one page, raw
  static constexpr int ROW = DP * 2;                     // a token's bf16 row in the tile
  static constexpr int TILE_PAGE = PAGE * ROW;           // k (or v) of one page, bf16
  static constexpr int CHUNKS = ROW / 16;
  static constexpr int SWZ = CHUNKS < 8 ? CHUNKS - 1 : 7;  // chunk swizzle mask
  static constexpr int WARP_BYTES = STAGES * 2 * RAW_PAGE + 2 * TILE_PAGE;
  static constexpr int SMEM = WARPS * WARP_BYTES;
  static_assert(WARPS * GMAX * DP * 4 <= SMEM, "the warps' acc must fit");
};

// One block per (partition, kv head, batch), four warps taking the
// partition's pages in turn. q is bf16 (q_bf16) or fp32, (B, KV, G, D);
// pages (P, 16, KV, D) of TK; part_acc (B, KV, n_part, G, D) and part_ml
// (.., G, 2) fp32, each partition's (acc, (m, l)). NT n tiles of 8
// queries, NS bf16 terms of q*scale and of the weights.
template <typename TK, int DP, int NT, int NS>
__global__ void __launch_bounds__(WARPS * 32)
paged_split_cvt(const void* __restrict__ q, int q_bf16, const TK* __restrict__ k_pages,
                const TK* __restrict__ v_pages, const int* __restrict__ tables,
                const int* __restrict__ lens, float* __restrict__ part_acc,
                float* __restrict__ part_ml, int KV, int G, int D, int max_blocks, int n_part,
                int window, float scale) {
  using P = Geom<TK, DP>;
  constexpr int KS = DP / 16;  // k-steps of q.k, m-tiles of p.v
  constexpr int GM = NTILE * NT;
  __shared__ __align__(16) __nv_bfloat16 qs[NS][GM][DP];
  __shared__ __align__(16) __nv_bfloat16 pw[WARPS][NS][GM][PAGE];
  __shared__ float ms[WARPS][GM];
  __shared__ float ls[WARPS][GM];
  extern __shared__ __align__(128) uint8_t smem[];  // the warps' rings and tiles, then their acc

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const Partition pt = partition_of(lens, b, max_blocks, window);
  if (pt.n_pages <= 0) return;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const size_t q_off = ((size_t)b * KV + kvh) * G * D;
  const size_t tok_stride = (size_t)KV * D;
  const int units = D / 8;  // 8-element units of a row (D is a multiple of 8)

  const int n_mine = pt.n_pages > warp ? (pt.n_pages - warp + WARPS - 1) / WARPS : 0;
  uint8_t* mine = smem + warp * P::WARP_BYTES;
  uint8_t* tile = mine + STAGES * 2 * P::RAW_PAGE;  // k then v, bf16
  auto issue = [&](int i) {
    const int pg = pt.page0 + warp + WARPS * i;
    const size_t base =
        (size_t)tables[(size_t)b * max_blocks + pg] * PAGE * tok_stride + (size_t)kvh * D;
    uint8_t* raw = mine + (i % STAGES) * 2 * P::RAW_PAGE;
    for (int c = lane; c < PAGE * units; c += 32) {
      const int tok = c / units, u = c % units;
      const size_t src = base + tok * tok_stride + u * 8;
      cp_async_unit<P::UNIT>(raw + tok * P::RAW_ROW + u * P::UNIT, k_pages + src);
      cp_async_unit<P::UNIT>(raw + P::RAW_PAGE + tok * P::RAW_ROW + u * P::UNIT,
                             v_pages + src);
    }
    hw::cp_async_commit();
  };
  // the tile's pad chunks (head dims D..DP-1), which no conversion writes
  const int pads = P::CHUNKS - units;
  for (int i = lane; i < PAGE * pads; i += 32) {
    const int tok = i / pads, ch = units + i % pads;
    const int sw = (ch ^ (tok & P::SWZ)) * 16;
    *reinterpret_cast<uint4*>(tile + tok * P::ROW + sw) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(tile + P::TILE_PAGE + tok * P::ROW + sw) = make_uint4(0, 0, 0, 0);
  }
  if (n_mine > 0) issue(0);
  if (n_mine > 1) issue(1);

  // q*scale kept in q's dtype, as NS bf16 terms; query rows G..GM-1 and
  // head dims D..DP-1 are zeros
  for (int i = tid; i < GM * DP; i += WARPS * 32) {
    const int g = i / DP, d = i % DP;
    float x = 0.f;
    if (g < G && d < D) {
      const size_t at = q_off + g * D + d;
      x = (q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at])
                  : static_cast<const float*>(q)[at]) * scale;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const __nv_bfloat16 h = __float2bfloat16(x);
      qs[s][g][d] = h;
      x -= __bfloat162float(h);
    }
  }
  __syncthreads();
  uint32_t qb[NS][NT][KS][2];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qb[s][nt][kk][0] =
            *reinterpret_cast<const uint32_t*>(&qs[s][NTILE * nt + gid][16 * kk + 2 * tig]);
        qb[s][nt][kk][1] =
            *reinterpret_cast<const uint32_t*>(&qs[s][NTILE * nt + gid][16 * kk + 8 + 2 * tig]);
      }

  // o[nt][mt][r]: head dim 16*mt + gid + 8*(r >> 1), query 8*nt + 2*tig + (r & 1)
  float o[NT][KS][4];
  float m[NT][2], l[NT][2];  // running (m, l)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[nt][mt][r] = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[nt][e] = NEG_INF;
      l[nt][e] = 0.f;
    }
  }
  const int mi = lane >> 3;
  const int k_tok = (lane & 7) + 8 * (mi & 1);
  const int v_tok = (lane & 7) + 8 * (mi >> 1);

  for (int i = 0; i < n_mine; ++i) {
    if (i + 1 < n_mine) hw::cp_async_wait<1>(); else hw::cp_async_wait<0>();
    __syncwarp();  // every lane's copies of page i have landed
    const int j = pt.page0 + warp + WARPS * i;
    const int n_valid = min(PAGE, pt.seq_len - j * PAGE);  // tokens in the sequence
    const int n_skip = max(0, pt.lo - j * PAGE);           // tokens left of the window
    const uint8_t* raw = mine + (i % STAGES) * 2 * P::RAW_PAGE;
    // the page into the tile; the rows of tokens that do not count are
    // zeros (their bytes may not be finite, and p.v reads them at p = 0)
    for (int c = lane; c < PAGE * units; c += 32) {
      const int tok = c / units, u = c % units;
      const int sw = (u ^ (tok & P::SWZ)) * 16;
      const bool keep = tok >= n_skip && tok < n_valid;
      const uint8_t* src = raw + tok * P::RAW_ROW + u * P::UNIT;
      *reinterpret_cast<uint4*>(tile + tok * P::ROW + sw) =
          keep ? unit_bf16<TK>(src) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(tile + P::TILE_PAGE + tok * P::ROW + sw) =
          keep ? unit_bf16<TK>(src + P::RAW_PAGE) : make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
    if (i + 2 < n_mine) issue(i + 2);  // the slot is free: its page is in the tile

    // S^T (16 tokens x 8 queries of each n tile) = K Q^T; sc[nt][r]: token
    // gid + 8*(r >> 1), query 8*nt + 2*tig + (r & 1)
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nt][r] = 0.f;
    const uint32_t k_row = hw::smem_addr(tile) + k_tok * P::ROW;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int ch = 2 * kk + (mi >> 1);
      uint32_t a[4];
      hw::ldmatrix_x4(a, k_row + ((ch ^ (k_tok & P::SWZ)) << 4));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int s = 0; s < NS; ++s) hw::mma_16816(sc[nt], a, qb[s][nt][kk]);
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
        const float alpha = expf(m[nt][e] - m_new);
        float p0 = valid0 ? expf(sc[nt][e] - m_new) : 0.f;
        float p1 = valid1 ? expf(sc[nt][2 + e] - m_new) : 0.f;
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
#pragma unroll
        for (int s = 0; s < NS; ++s) {  // NS bf16 terms of each weight
          const __nv_bfloat16 h0 = __float2bfloat16(p0), h1 = __float2bfloat16(p1);
          pw[warp][s][NTILE * nt + 2 * tig + e][gid] = h0;
          pw[warp][s][NTILE * nt + 2 * tig + e][gid + 8] = h1;
          p0 -= __bfloat162float(h0);
          p1 -= __bfloat162float(h1);
        }
      }
    __syncwarp();
    // P^T as the B operand: column gid of n tile nt is query 8*nt + gid
    uint32_t pb[NS][NT][2];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        pb[s][nt][0] = *reinterpret_cast<const uint32_t*>(&pw[warp][s][NTILE * nt + gid][2 * tig]);
        pb[s][nt][1] =
            *reinterpret_cast<const uint32_t*>(&pw[warp][s][NTILE * nt + gid][8 + 2 * tig]);
      }
    // O^T (DP x 8 queries of each n tile) += V^T P^T, 16 head dims at a time
    const uint32_t v_row = hw::smem_addr(tile + P::TILE_PAGE) + v_tok * P::ROW;
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      const int ch = 2 * mt + (mi & 1);
      uint32_t a[4];
      hw::ldmatrix_x4_trans(a, v_row + ((ch ^ (v_tok & P::SWZ)) << 4));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int s = 0; s < NS; ++s) hw::mma_16816(o[nt][mt], a, pb[s][nt]);
    }
    __syncwarp();  // pw and the tile are rewritten next
  }

  __syncthreads();  // every warp is done with its ring and tile: they now hold the accs
  float* accs = reinterpret_cast<float*>(smem);  // [WARPS][GM][DP]
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
  const size_t pidx = ((size_t)b * KV + kvh) * n_part + blockIdx.x;
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
      A += accs[(w * GM + g) * DP + d] * f;
    }
    part_acc[pidx * G * D + i] = A;
    if (d == 0) {
      part_ml[(pidx * G + g) * 2] = M;
      part_ml[(pidx * G + g) * 2 + 1] = L;
    }
  }
}

// The range of partitions a (batch, kv head) wrote: [p_first, np); all
// n_part without lens (a caller's gathered partitions, the unwritten ones
// filled by the caller).
__device__ __forceinline__ void written(const int* lens, int b, int max_blocks, int n_part,
                                        int window, int& p_first, int& np) {
  np = lens ? (pages_used(lens[b], max_blocks) + PART - 1) / PART : n_part;
  p_first = lens ? window_start(lens[b], window) / PAGE / PART : 0;
}

// ONEPASS's merge into out (B, KV, G, D) of TQ: sum_p acc_p e^(m_p - M) /
// sum_p l_p e^(m_p - M) (paged_attention.cu's paged_merge, D at run time).
template <typename TQ>
__global__ void __launch_bounds__(128)
cvt_merge(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
          const int* __restrict__ lens, TQ* __restrict__ out, int KV, int G, int D,
          int max_blocks, int n_part, int window) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  int p_first, np;
  written(lens, b, max_blocks, n_part, window, p_first, np);
  const size_t p0 = ((size_t)b * KV + kvh) * n_part;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    float M = NEG_INF;
    for (int p = p_first; p < np; ++p) M = fmaxf(M, part_ml[((p0 + p) * G + g) * 2]);
    float L = 0.f, A = 0.f;
    for (int p = p_first; p < np; ++p) {
      const float f = expf(part_ml[((p0 + p) * G + g) * 2] - M);
      L += part_ml[((p0 + p) * G + g) * 2 + 1] * f;
      A += part_acc[(p0 + p) * G * D + i] * f;
    }
    out[((size_t)b * KV + kvh) * G * D + i] = from_f<TQ>(L > 0.f ? A / L : 0.f);
  }
}

// Partials (B, KV, n_part, G, D) fp32 added into out (B, KV, G, D) of TQ:
// the sequence split's sums of the ranks' shares (paged_cvt_sum).
template <typename TQ>
__global__ void __launch_bounds__(128)
part_sum(const float* __restrict__ part_acc, TQ* __restrict__ out, int KV, int G, int D,
         int n_part) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const size_t p0 = ((size_t)b * KV + kvh) * n_part;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    float A = 0.f;
    for (int p = 0; p < n_part; ++p) A += part_acc[(p0 + p) * G * D + i];
    out[((size_t)b * KV + kvh) * G * D + i] = from_f<TQ>(A);
  }
}

// The split kernel over every partition of the table.
template <typename TK, int DP, int NT, int NS>
cudaError_t launch_split(const void* q, int q_bf16, const void* kp, const void* vp,
                         const void* tables, const void* lens, float* part_acc, float* part_ml,
                         int B, int KV, int G, int D, int max_blocks, int window, float scale,
                         cudaStream_t stream) {
  constexpr int SMEM = Geom<TK, DP>::SMEM;
  static bool attr_set = false;  // the opt-in above 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute((const void*)paged_split_cvt<TK, DP, NT, NS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_part = (max_blocks + PART - 1) / PART;
  paged_split_cvt<TK, DP, NT, NS><<<dim3(n_part, KV, B), WARPS * 32, SMEM, stream>>>(
      q, q_bf16, static_cast<const TK*>(kp), static_cast<const TK*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(lens), part_acc, part_ml, KV, G,
      D, max_blocks, n_part, window, scale);
  return cudaGetLastError();
}

// Calls f with the page type, the geometry DP and the n tiles NT as
// std::integral_constant values (an unknown page code or head dim is
// cudaErrorInvalidValue). D is a multiple of 8 up to 128. fp32 pages only
// with F32 (the upcast mode's).
template <bool F32 = false, typename F>
cudaError_t dispatch(int page_dtype, int D, int G, F&& f) {
  if (D < 8 || D > 128 || D % 8 || G < 1 || G > GMAX) return cudaErrorInvalidValue;
  auto with_nt = [&](auto t, auto dp) -> cudaError_t {
    if (G <= NTILE) return f(t, dp, std::integral_constant<int, 1>{});
    return f(t, dp, std::integral_constant<int, 2>{});
  };
  auto with_dp = [&](auto t) -> cudaError_t {
    if (D <= 32) return with_nt(t, std::integral_constant<int, 32>{});
    if (D <= 64) return with_nt(t, std::integral_constant<int, 64>{});
    return with_nt(t, std::integral_constant<int, 128>{});
  };
  if (page_dtype == PAGE_E4M3) return with_dp(E4M3{});
  if (page_dtype == PAGE_INT8) return with_dp(int8_t{});
  if (page_dtype == PAGE_BF16) return with_dp(__nv_bfloat16{});
  if constexpr (F32)
    if (page_dtype == PAGE_F32) return with_dp(float{});
  return cudaErrorInvalidValue;
}

}  // namespace paged_cvt
