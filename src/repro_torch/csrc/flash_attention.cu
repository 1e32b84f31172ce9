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
// where the H100 stops being memory bound, so it is bound by arithmetic,
// and in bf16 only the tensor cores (wgmma) come near that bound.
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
// fp32, flash_fwd_simt (the fp32 checks): one block of 256 threads per
// (64-row q tile, q head, batch); k and v tiles are staged in shared memory
// and both products run on the fp32 FMA units, with the same loop bounds.
//
// Head dims: 32, 64 and 128, and the padded instances 80, 112 and 120. A
// padded instance runs the wgmma kernel on the 128 geometry: its tensor
// maps keep the real D as the inner extent (rows of 160, 224 or 240 bytes,
// multiples of 16), so TMA zero-fills columns D..127 of the second
// 64-column box of q, k and v; the zero columns add nothing to Q K^T, P V
// computes 128 output columns and the epilogue stores D of them. The
// default scale is the real D's. The SIMT kernel takes any D (its output
// columns are masked past D).

#define FLASH_CAUSAL 1
#define FLASH_ENTRY flash_attention_fwd
#include "flash_attention.cuh"
