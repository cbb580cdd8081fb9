"""Symbol-space mappings on the host: msb bucketing (ans_msb.hpp:41-50,
156-176), the byte fold and its un-fold table (ans_fold.hpp:38-65,
150-175), and the rfold reorder pass (ans_reorder_fold.hpp:69-106).  A
copy of what the port calls from ans_tpu/reference_model/mappings.py, held
equal to it by tests/test_torch_host.py.

All functions operate on uint32 arrays (or scalars) and return uint32.
Exception bytes are the stripped low bytes, emitted lowest-byte-first.
"""

from __future__ import annotations

import numpy as np

from ..constants import fold_offset_step, fold_threshold


# --------------------------- msb (magnitude buckets) -----------------------

def msb_map(x):
    """u32 -> bucket id in [0, 1280) (ans_msb.hpp:41-50). Note the <=
    comparisons: 256 maps to itself, 2**16 maps to 512, 2**24 to 768."""
    x = np.asarray(x, dtype=np.uint32)
    out = np.where(
        x <= 256, x,
        np.where(x <= (1 << 16), (x >> 8) + 256,
                 np.where(x <= (1 << 24), (x >> 16) + 512, (x >> 24) + 768)))
    return out.astype(np.uint32)


def msb_exception_bytes(bucket):
    """# stripped low bytes for a bucket id (ans_msb.hpp:167-176)."""
    b = np.asarray(bucket, dtype=np.uint32)
    return (
        (b > 256).astype(np.uint32)
        + (b > 512).astype(np.uint32)
        + (b > 768).astype(np.uint32)
    )


def msb_unmap_high(bucket):
    """High part reconstructed from the bucket id (ans_msb.hpp:156-165);
    the stripped low bytes are added back from the exception stream."""
    b = np.asarray(bucket, dtype=np.uint32)
    out = np.where(
        b <= 256, b,
        np.where(b <= 512, (b - 256) << np.uint32(8),
                 np.where(b <= 768, (b - 512) << np.uint32(16),
                          (b - 768) << np.uint32(24))))
    return out.astype(np.uint32)


# --------------------------- generalized fold ------------------------------


# --------------------------- generalized fold ------------------------------

def fold_exception_count(x, fidelity: int):
    """Number of low bytes stripped when folding x (loop count of
    ans_fold.hpp:44-48): k = min k such that x >> 8k < 2**(fidelity+7)."""
    x = np.asarray(x, dtype=np.uint32)
    thres = np.uint32(fold_threshold(fidelity))
    k = np.zeros(x.shape, dtype=np.uint32)
    for i in range(1, 4):
        k += (x >> np.uint32(8 * (i - 1))) >= thres
    # a 4th strip can never trigger: after 3 strips x < 2**8 <= thres
    return k


def fold_map(x, fidelity: int):
    """u32 -> folded symbol id (ans_fold.hpp:38-50)."""
    x = np.asarray(x, dtype=np.uint32)
    k = fold_exception_count(x, fidelity)
    step = np.uint32(fold_offset_step(fidelity))
    return ((x >> (np.uint32(8) * k)) + step * k).astype(np.uint32)


def fold_exceptions(x, fidelity: int):
    """(k, bytes) where bytes is an (n,3) u8 array of the stripped low
    bytes in emission order (lowest byte first); only bytes[:, :k] valid."""
    x = np.asarray(x, dtype=np.uint32)
    k = fold_exception_count(x, fidelity)
    b = np.empty(x.shape + (3,), dtype=np.uint8)
    b[..., 0] = (x & 0xFF).astype(np.uint8)
    b[..., 1] = ((x >> np.uint32(8)) & 0xFF).astype(np.uint8)
    b[..., 2] = ((x >> np.uint32(16)) & 0xFF).astype(np.uint8)
    return k, b


def fold_unmap_high(sym, fidelity: int):
    """High part reconstructed from a folded id (ans_fold.hpp:150-161)."""
    sym = np.asarray(sym, dtype=np.uint32)
    thres = np.uint32(fold_threshold(fidelity))
    div = np.uint32(fold_offset_step(fidelity))
    folded = sym >= thres
    nb = np.where(folded, (sym - thres) // div + np.uint32(1), np.uint32(0))
    high = np.where(folded,
                    (sym - div * nb) << (np.uint32(8) * nb),
                    sym)
    return high.astype(np.uint32), nb.astype(np.uint32)


def craft_reorder(values: np.ndarray, fidelity: int):
    """rfold reorder pass: remap the `fold_threshold(f)` most-frequent
    raw values to the low ids (reference ans_reorder_fold.hpp
    craft_reorder; order = std::sort over (first=-count, second=sym)).
    Returns (remapped u32 values, wire header: u32 reorder flag
    [+ thres u32 top symbols]).  Shared by the compat and lane engines,
    the block runtime, and the benchmark harness — the header bytes are
    format, so there is exactly one implementation."""
    max_raw = int(values.max()) if len(values) else 0
    counts = np.bincount(values, minlength=max_raw + 1)
    mapping, header = craft_reorder_from_counts(counts, fidelity)
    if mapping is None:
        return values, header
    return mapping[values], header


def craft_reorder_from_counts(counts: np.ndarray, fidelity: int):
    """Derive the rfold permutation from a raw-value histogram alone.
    Deterministic in `counts`, so multi-host processes that allreduce
    their local histograms all compute the identical `top` list (the
    reference builds the permutation from global counts the same way,
    ans_reorder_fold.hpp:74-106; order = (-count, sym)).  Returns
    (mapping u32 array or None when fewer than `thres` symbols are
    present, wire header bytes)."""
    thres = fold_threshold(fidelity)
    present = np.flatnonzero(counts)
    if len(present) < thres:
        return None, (0).to_bytes(4, "little")
    order = np.lexsort((present, -np.asarray(counts)[present]))
    top = present[order[:thres]].astype(np.uint32)
    mapping = np.arange(len(counts), dtype=np.uint32) + np.uint32(thres)
    mapping[top] = np.arange(thres, dtype=np.uint32)
    return mapping, ((1).to_bytes(4, "little")
                     + top.astype("<u4").tobytes())
