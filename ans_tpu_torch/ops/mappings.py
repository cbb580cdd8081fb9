"""Device-side symbol mappings, the byte fold and msb bucketing (PyTorch
counterpart of ans_tpu/ops/mappings_jax.py; provenance:
ans_tpu/reference_model/mappings.py, reference ans_fold.hpp:38-65 and
ans_msb.hpp:41-50, 167-176).

u32 values travel as i32 bit patterns; the arithmetic runs in int64,
since torch lacks unsigned shifts and compares for 32-bit integers."""

from __future__ import annotations

import torch

from ..constants import fold_offset_step, fold_threshold


def fold_map_hist(x: torch.Tensor, *, fidelity: int, length: int):
    """Fused fold map + exception extraction + histogram.

    x: (n,) i32 bit patterns of the u32 values.  Returns
      mapped (n,) i32 folded symbol ids,
      k      (n,) i32 exception-byte counts (0..3),
      low    (n,) i32 the three low bytes of x (x & 0xFFFFFF; byte i is
             the i-th stripped exception byte, lowest first),
      hist   (length,) i64 histogram of mapped.
    """
    v = x.to(torch.int64) & 0xFFFFFFFF
    thres = fold_threshold(fidelity)
    k = torch.zeros_like(v)
    for i in range(3):
        k += (v >> (8 * i)) >= thres
    mapped = (v >> (8 * k)) + fold_offset_step(fidelity) * k
    hist = torch.bincount(mapped, minlength=length)
    return (mapped.to(torch.int32), k.to(torch.int32),
            (v & 0xFFFFFF).to(torch.int32), hist)


def msb_map_hist(x: torch.Tensor, *, length: int):
    """Fused msb bucketing + exception extraction + histogram.

    x: (n,) i32 bit patterns of the u32 values.  Returns mapped (n,) i32
    bucket ids in [0, 1280) (x <= 256 maps to itself, then 256 + x >> 8
    up to 2^16, 512 + x >> 16 up to 2^24, 768 + x >> 24), k (n,) i32 the
    stripped low bytes (0..3: one for each of 256, 512, 768 the bucket
    passes), low (n,) i32 the three low bytes of x, hist (length,) i64."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    mapped = torch.where(
        v <= 256, v, torch.where(
            v <= 1 << 16, (v >> 8) + 256, torch.where(
                v <= 1 << 24, (v >> 16) + 512, (v >> 24) + 768)))
    k = ((mapped > 256).to(torch.int64) + (mapped > 512).to(torch.int64)
         + (mapped > 768).to(torch.int64))
    hist = torch.bincount(mapped, minlength=length)
    return (mapped.to(torch.int32), k.to(torch.int32),
            (v & 0xFFFFFF).to(torch.int32), hist)
