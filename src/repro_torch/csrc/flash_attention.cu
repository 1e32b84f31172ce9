// Flash-attention prefill for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: the Pallas TPU kernel flash_attention_kernel (body _flash_kernel)
// in src/repro/kernels/flash_attention/kernel.py.
//
// Computes causal, optionally sliding-window GQA attention. q (B,Sq,H,D),
// k/v (B,Skv,KV,D), out (B,Sq,H,D), all contiguous, fp32 or bf16; q head h
// reads kv head h / (H/KV). lens[b] is the EXCLUSIVE valid kv length; a row
// with no valid key writes 0. Query positions start at 0; scores are scaled
// by the caller's scale. The kernels are in flash_attention.cuh, compiled
// here with FLASH_CAUSAL 1; flash_attention_noncausal.cu compiles them with
// FLASH_CAUSAL 0 (key kp counts for row qp when kp < lens[b] and, with a
// window, kp > qp - window: the reference kernel's causal=False) into a
// library of its own, so that the causal instances' code stays as it was.
//
// Bound on this card: at the main path's prompts (S 512-2048, 24 heads,
// D 128) the work is about 2*2*S^2/2*H*D operations per layer against
// (2*S*H + 2*S*KV)*D elements moved, far above the ~295 operations per byte
// where the H100 stops being memory bound, so it is bound by arithmetic:
// in bf16 only the tensor cores (wgmma) come near that bound; in fp32 the
// FP32 pipes' 67 TFLOP/s (NVIDIA H100 80GB HBM3 at 700 W): at (1, 1000,
// 24, 8, 128) causal 6.15 GFLOP over 32.8 MB of q, k, v and out, about 190
// operations a byte against the 20 where fp32 arithmetic and HBM balance,
// so 0.0918 ms, bound by operations.
//
// Two instances, chosen by dtype (never a fallback of one another):
//
// bf16, flash_fwd_wgmma (the main path's): one block per (128-row q tile,
// q head, batch) of two consumer warpgroups, each owning 64 q rows, and one
// producer warp. The producer loads the q tile and then the k and v tiles
// (128 keys) by TMA into a 2-stage ring, each completing on its own mbarrier,
// so tile j+1 arrives while tile j is computed; the consumers release a
// stage on an "empty" mbarrier. Operands stay bf16 in shared memory in the
// 128-byte (64-byte at D=32) swizzle TMA writes and wgmma reads. Each
// consumer scales its q rows (by D^-0.5 unless the caller gives a scale)
// and rounds them to bf16 once, in place, as the TPU kernel does before its
// first product; S = Q K^T is a
// wgmma m64n128k16 chain over D with both operands in shared memory; the
// online softmax runs on the fp32 accumulators in registers; P is rounded to
// bf16 and fed from registers as the A operand of O += P V (wgmma
// m64nDk16, V read transposed from shared memory). Running max, sum and O
// stay fp32. The kv loop starts at the window's left edge and stops at the
// causal diagonal and at lens[b]: masked-out tiles are neither loaded nor
// multiplied, and only tiles that cross the diagonal, the window's edge or
// lens[b] evaluate the mask. TMA fills the ragged edge (rows past Sq or
// Skv) with zeros, so the host pads nothing. Blocks take q tiles from the
// last (longest causal row range) to the first. Tiles are 128 keys wide:
// at 64, each m64n64k16 reads about as many shared-memory bytes per
// operation as the SM delivers, and 128 was faster at the main path's
// prompt lengths; overlapping the softmax with the next tile's wgmma inside
// a warpgroup was slower (PERF.md, Findings).
//
// fp32, flash_fwd_simt (the fp32 equality runs and levers): every product
// an IEEE fp32 FMA on the FP32 pipes (no TF32, no tensor cores). One block
// of four warps per (64-row q tile, q head, batch), two blocks an SM (at
// D 128, 115,712 bytes of shared memory each; __launch_bounds__(128, 2)).
// Thread 0 loads the q tile once, then the 64-key k and v tiles, by TMA, q
// and k in 32-column boxes under the 128-byte swizzle, v in one dense box,
// each tile on its own mbarrier: the k tile j+1 is issued as soon as every
// warp is done with S_j (and arrives during P_j V_j), the v tile j+1 as
// soon as P_j V_j is done (and arrives during S_j+1). q is scaled in place
// once. Each thread owns 8 q rows (rg + 8i): S = Q K^T as 8 rows x 4 keys
// on 128-bit loads, 12 a 4-column chunk for 128 FMAs (a half-warp's q rows
// are broadcasts, its 16 keys one 16-byte chunk of 16 rows: the swizzle
// spreads them over the banks); the online softmax in registers, a row's
// max and sum over the 16 lanes of a half-warp, expf as before; P through a
// 16 KB shared tile (its 16-byte chunks swizzled by the key, so writes and
// reads are conflict-free); O += P V as 8 rows x 8 columns (D 128), two
// 128-bit loads of P and two of v a key for 64 FMAs. Both products run at
// 88-92% FMAs in their loops (the SASS). The kv loop has the bf16 kernel's
// bounds and masks (window, diagonal, lens[b]; only edge tiles mask), and
// its P V stops at the last key that counts for any of the block's rows.
// Blocks take q tiles from the last (longest causal row range) to the
// first across every head (the q tile is the grid's slow axis), so the
// heaviest run first. TMA zero-fills rows past Sq and Skv and the columns
// of a 32-column box past D. Its time at (1, 1000, 24, 8, 128): PERF.md.
//
// Head dims: 32, 64 and 128, and the padded instances 80, 112 and 120. A
// padded instance runs the wgmma kernel on the 128 geometry: its tensor
// maps keep the real D as the inner extent (rows of 160, 224 or 240 bytes,
// multiples of 16), so TMA zero-fills columns D..127 of the second
// 64-column box of q, k and v; the zero columns add nothing to Q K^T, P V
// computes 128 output columns and the epilogue stores D of them. The
// default scale is the real D's. The SIMT kernel reads q and k in
// ceil(D/32) column blocks (the zero columns past D skipped in Q K^T) and v
// in rows of D rounded up to 16; a lane's D/16 output columns (8 at D 120,
// its pad unstored) are pieces of 4, 2 and 1 columns.

#define FLASH_CAUSAL 1
#define FLASH_ENTRY flash_attention_fwd
#include "flash_attention.cuh"
