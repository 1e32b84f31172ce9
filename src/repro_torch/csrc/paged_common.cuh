// The layout both paged-attention libraries share: a page's tokens, the
// warps of a split block, the partitions of a table, and a split block's
// place in its sequence. Included by paged_attention.cu (pages of q's
// dtype) and paged_cvt.cuh (pages of another dtype).
#pragma once

#include "common.cuh"

namespace repro_torch::paged {

constexpr int PAGE = 16;
constexpr int WARPS = 4;
constexpr int GMAX = 16;    // most q heads per kv head the kernel takes
constexpr int NTILE = 8;    // queries per n tile of m16n8k16
constexpr int PART = 16;    // pages per partition
constexpr int STAGES = 2;   // pages in flight per warp

__host__ __device__ constexpr int pages_used(int len, int max_blocks) {
  return (len + PAGE) / PAGE < max_blocks ? (len + PAGE) / PAGE : max_blocks;
}

// First key position inside the window of a sequence whose newest token is
// at len (0 without a window).
__host__ __device__ constexpr int window_start(int len, int window) {
  return window > 0 && len - window + 1 > 0 ? len - window + 1 : 0;
}

// The block's place in the sequence: its pages are page0 .. page0+n_pages-1,
// keys lo .. seq_len-1 count.
struct Partition {
  int seq_len, lo, page0, n_pages;
};

__device__ __forceinline__ Partition partition_of(const int* lens, int b, int max_blocks,
                                                  int window) {
  const int len = lens[b];
  const int lo = window_start(len, window);
  const int page0 = max((int)blockIdx.x * PART, lo / PAGE);
  const int end = min(((int)blockIdx.x + 1) * PART, pages_used(len, max_blocks));
  return {len + 1, lo, page0, end - page0};
}

}  // namespace repro_torch::paged
