"""The decode cache's dtype (the reference's ``ParallelContext.kv_cache_dtype``)
and the casts into it.

``to_cache_dtype`` casts as ``jnp.astype`` does on the reference's CPU,
where torch's ``.to`` differs:

- int8: saturate, then truncate toward zero (-300.7 -> -128, 500 -> 127,
  NaN -> 0); torch wraps (-300.7 -> -44, 500 -> -12);
- float8_e4m3fn: round to nearest even, subnormals included, and NaN for
  |x| > 464, the values that round past 448, the largest finite (infinities
  too); torch saturates to 448;
- bfloat16, float32: round to nearest even, as both do.

Every write into a pool and every rounding of an operand to the cache's
dtype goes through it. On the meta device (the dry-run's count) it is a
plain ``.to``, so the count books no extra elementwise ops.
"""
from __future__ import annotations

import torch

# the dtypes a decode cache may have; an 8-bit cache has no scale, as the
# reference's has none
CACHE_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn, torch.int8)
E4M3_NAN_FROM = 464.0   # |x| above this rounds past e4m3's largest finite, 448


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to ``dtype`` as ``jnp.astype`` casts (the module
    docstring)."""
    if x.dtype == dtype or x.device.type == "meta":
        return x.to(dtype)
    if dtype == torch.int8:
        y = torch.nan_to_num(x.float(), nan=0.0)
        return y.clamp(-128.0, 127.0).trunc().to(torch.int8)
    if dtype == torch.float8_e4m3fn:
        y = x.float()
        return torch.where(y.abs() > E4M3_NAN_FROM, float("nan"), y).to(dtype)
    return x.to(dtype)


def check_cache_dtype(dtype: torch.dtype):
    if dtype not in CACHE_DTYPES:
        raise ValueError(f"kv cache dtype {dtype}: need one of "
                         f"{[str(d) for d in CACHE_DTYPES]}")


def writable(pool: torch.Tensor) -> torch.Tensor:
    """A view of ``pool`` that indexed writes and ``where`` take on every
    device: the bytes of an fp8 pool (whose values were cast already)."""
    return pool.view(torch.uint8) if pool.dtype == torch.float8_e4m3fn else pool
