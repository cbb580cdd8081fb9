"""Device-side byte-fold mapping (PyTorch counterpart of
ans_tpu/ops/mappings_jax.py; provenance: ans_tpu/reference_model/
mappings.py, reference ans_fold.hpp:38-65).

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
