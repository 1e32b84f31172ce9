// Flash-attention prefill for Hopper (sm_90a), non-causal: the kernels of
// flash_attention.cuh compiled with FLASH_CAUSAL 0, the reference wrapper's
// causal=False (src/repro/kernels/flash_attention/kernel.py, causal=False).
// Every key below lens[b] counts for every query row (Sq and Skv
// independent), within the window where one is given. Its own library, so
// that the causal instances in flash_attention.cu compile as they did.

#define FLASH_CAUSAL 0
#define FLASH_ENTRY flash_attention_noncausal_fwd
#include "flash_attention.cuh"
