"""Frequency-grouped slot layout: the large-alphabet path of the lane
format.  A NumPy copy of ans_tpu/ops/grouped.py (the layout half), held
equal to it by tests/test_torch_host.py.

Present symbols are ranked by (frequency desc, value asc) and slots are
assigned in rank order; symbols sharing one frequency f form a GROUP of
count*f contiguous slots, laid out symbol-major (rank j of the group
owns slots [g_slot0 + j*f, g_slot0 + (j+1)*f)).  Frequencies sum to M,
so there are NG <= sqrt(2M) <= 2896 groups whatever sigma is.  Decode
finds the group by a binary search over the NG slot boundaries and the
in-group index by one exact Granlund-Montgomery division; encode finds
the group of a rank by a search over the NG rank boundaries, with
base(rank) = g_slot0 + (rank - g_rank0) * f.

The layout is wire format: it decides the slot order the encoder emits,
and both coder sides derive it from the prelude frequencies alone.  The
TPU's bit-packed plane tables (ans_tpu/ops/grouped.py Plane and the
anchored representation) are a lookup representation for Mosaic's
128-lane shuffles and are not ported: the card gathers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# FORMAT CONSTANT: alphabets with this many live symbols use the
# frequency-grouped slot layout (decoders re-derive it from nfreqs)
GROUPED_MIN_SIGMA = (1 << 13) + 1


def use_grouped_layout(nfreqs) -> bool:
    """Pure function of the prelude frequency vector (both coder sides
    must agree)."""
    return int(np.count_nonzero(np.asarray(nfreqs))) >= GROUPED_MIN_SIGMA


def _gm_magic(f: np.ndarray):
    """Granlund-Montgomery round-up division magics for u32 / f (0 for
    f < 2): with l = ceil(log2 f), magic = floor(2^(32+l)/f) + 1 - 2^32,
    and t = mulhi32(x, magic); q = (t + ((x - t) >> 1)) >> (l - 1) is
    x // f for every u32 x."""
    f = np.asarray(f).astype(np.uint64)
    magic = np.zeros(len(f), dtype=np.uint32)
    big = f >= 2
    if big.any():
        d = f[big]
        # bit_length of d-1: the frexp exponent is exact for d-1 < 2^22
        l = np.frexp((d - np.uint64(1)).astype(np.float64))[1].astype(
            np.uint64)
        magic[big] = (((np.uint64(1) << (np.uint64(32) + l)) // d)
                      + np.uint64(1) - (np.uint64(1) << np.uint64(32))
                      ).astype(np.uint32)
    return magic


def _search_pivots(bounds: np.ndarray, pad_value: int):
    """Bitwise-binary-search pivot levels over a sorted boundary array:
    level k probes bounds[(m << (k+1)) + 2^k], deepest level first,
    padded with pad_value."""
    nb = len(bounds)
    depth = (nb - 1).bit_length() if nb > 1 else 0
    P = 1 << depth
    pad = np.full(P, pad_value, dtype=np.int64)
    pad[:nb] = bounds
    pivots = []
    for k in range(depth):
        idxs = (np.arange(P >> (k + 1)) << (k + 1)) + (1 << k)
        pivots.append(pad[idxs].astype(np.int32))
    return tuple(pivots), depth


@dataclass(frozen=True)
class GroupLayout:
    """Host-side description of the frequency-grouped frame."""

    perm: np.ndarray        # u32 (sigma,) rank -> symbol id
    rank_of: np.ndarray     # u32 (len(nfreqs),) symbol id -> rank (0 if absent)
    g_f: np.ndarray         # u32 (NG,) frequency of each group
    g_rank0: np.ndarray     # u32 (NG,) first rank of each group
    g_slot0: np.ndarray     # u32 (NG,) first slot of each group
    g_magic: np.ndarray     # u32 (NG,) GM magic for division by g_f
    slot_pivots: tuple      # levels for slot -> group (pad M)
    slot_depth: int
    rank_pivots: tuple      # levels for rank -> group (pad sigma)
    rank_depth: int
    sigma: int
    frame_size: int
    log2m: int

    @property
    def num_groups(self) -> int:
        return len(self.g_f)


def build_group_layout(nfreqs) -> GroupLayout:
    nf = np.asarray(nfreqs, dtype=np.int64)
    M = int(nf.sum())
    if M & (M - 1):
        raise ValueError(f"frame size {M} not a power of two")
    log2m = M.bit_length() - 1
    nz = np.flatnonzero(nf)
    if len(nz) == 0:
        raise ValueError("empty frequency vector")
    fz = nf[nz]
    # rank order: (freq desc, symbol asc); np.lexsort's last key is
    # primary and the sort is stable
    order = np.lexsort((nz, -fz))
    perm = nz[order].astype(np.uint32)
    f_sorted = fz[order]
    rank_of = np.zeros(len(nf), dtype=np.uint32)
    rank_of[perm] = np.arange(len(perm), dtype=np.uint32)
    # group boundaries = runs of equal frequency in rank order
    starts = np.flatnonzero(np.diff(f_sorted, prepend=f_sorted[0] + 1))
    g_f = f_sorted[starts]
    g_rank0 = starts.astype(np.int64)
    counts = np.diff(np.append(starts, len(perm)))
    g_slot0 = np.concatenate(([0], np.cumsum(counts * g_f)[:-1]))
    slot_pivots, slot_depth = _search_pivots(g_slot0, M)
    rank_pivots, rank_depth = _search_pivots(g_rank0, len(perm))
    return GroupLayout(
        perm=perm, rank_of=rank_of,
        g_f=g_f.astype(np.uint32), g_rank0=g_rank0.astype(np.uint32),
        g_slot0=g_slot0.astype(np.uint32), g_magic=_gm_magic(g_f),
        slot_pivots=slot_pivots, slot_depth=slot_depth,
        rank_pivots=rank_pivots, rank_depth=rank_depth,
        sigma=len(perm), frame_size=M, log2m=log2m)
