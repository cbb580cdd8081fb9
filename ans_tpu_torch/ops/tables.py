"""Encoder/decoder tables for the lane-format rANS engine.

A NumPy copy of the table builders in ans_tpu/ops/tables.py (held equal
to them by tests/test_torch_host.py) plus `to_device`, which lays a table
out as the device tensors the CUDA kernels and their plain versions read.
Frames with more than 2^13 live symbols use the frequency-grouped slot
layout (ops/grouped.py): their decode table is a `GroupedTable`, their
encoder's tables come from `grouped_enc_to_device`.  `materialize_slots`
turns either decode table into the per-slot `SlotTable` of the direct
engine, for frames small enough to keep it in shared memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import A_KM_LOG2, A_MAX_FRAME_LOG2
from .grouped import (GroupLayout, _gm_magic, build_group_layout,
                      use_grouped_layout)

# fmt A lower bound: state in [A_L, 256*A_L)
A_L = 1 << A_KM_LOG2


def max_renorm_rounds(log2m: int) -> int:
    """Renorm byte reads per decode step: 2 while M <= 2^16, 3 beyond.
    Encoder placement and decoder reads must agree on this bound."""
    return 2 if log2m <= 16 else 3


@dataclass(frozen=True)
class EncTable:
    """Per-symbol encode table (index = mapped symbol id).  magic
    implements exact division by freq d via a 32-bit multiply-high
    (Granlund-Montgomery round-up variant, Hacker's Delight 10-10): with
    l = ceil(log2 d) and magic = floor(2^(32+l)/d) + 1 - 2^32,
        t = mulhi32(x, magic); q = (t + ((x - t) >> 1)) >> (l - 1)
    is exact for every u32 x and d >= 2; d == 1 is selected around.  The
    kernel derives l and the renorm bound from freq itself."""

    freq: np.ndarray  # u32 (sigma,)
    base: np.ndarray  # u32 (sigma,) cumulative freq
    magic: np.ndarray  # u32 (sigma,) GM round-up multiplier (0 for d=1)
    frame_size: int
    log2m: int


@dataclass(frozen=True)
class SearchTable:
    """Decode table for the pivot search: slot -> symbol by bitwise
    binary search over the cumulative-frequency bases of the present
    (freq > 0) symbols.  pivots[k] holds base[m * 2^(k+1) + 2^k] for
    level k of the search (k = depth-1 is probed first), padded with M
    past the live alphabet."""

    pivots: tuple  # level k -> (P >> (k+1),) i32 base values
    depth: int
    val: np.ndarray | None  # u32 (sigma,) raw value per dense id
    high: np.ndarray | None  # u32 (sigma,)
    nb: np.ndarray | None  # u32 (sigma,)
    sigma: int  # dense (present-symbol) count
    frame_size: int
    log2m: int


def _check_frame(M: int) -> int:
    if M & (M - 1):
        raise ValueError(f"frame size {M} not a power of two")
    log2m = M.bit_length() - 1
    if log2m > A_MAX_FRAME_LOG2:
        raise ValueError(
            f"frame 2**{log2m} exceeds the lane format's limit "
            f"2**{A_MAX_FRAME_LOG2}; pass max_frame to the codec")
    return log2m


def build_enc_table(nfreqs: np.ndarray) -> EncTable:
    nf = np.asarray(nfreqs, dtype=np.uint64)
    M = int(nf.sum())
    log2m = _check_frame(M)
    base = np.concatenate(([0], np.cumsum(nf)[:-1])).astype(np.uint32)
    return EncTable(freq=nf.astype(np.uint32), base=base,
                    magic=_gm_magic(nf), frame_size=M, log2m=log2m)


def build_search_table(nfreqs: np.ndarray,
                       high_of_sym: np.ndarray | None = None,
                       nb_of_sym: np.ndarray | None = None) -> SearchTable:
    nf = np.asarray(nfreqs, dtype=np.int64)
    M = int(nf.sum())
    log2m = _check_frame(M)
    nz = np.flatnonzero(nf)
    sigma = len(nz)
    depth = (sigma - 1).bit_length() if sigma > 1 else 0
    P = 1 << depth
    base_pad = np.full(P, M, dtype=np.int32)
    base_pad[:sigma] = np.concatenate(
        ([0], np.cumsum(nf[nz])[:-1])).astype(np.int32)
    pivots = []
    for k in range(depth):
        idxs = (np.arange(P >> (k + 1)) << (k + 1)) + (1 << k)
        pivots.append(base_pad[idxs])
    if high_of_sym is not None:
        high = np.asarray(high_of_sym, dtype=np.uint32)[nz]
        nb = np.asarray(nb_of_sym, dtype=np.uint32)[nz]
        val = None
    else:
        high = nb = None
        # identity when every symbol id 0..sigma-1 is present
        val = None if sigma == len(nf) else nz.astype(np.uint32)
    return SearchTable(pivots=tuple(pivots), depth=depth, val=val,
                       high=high, nb=nb, sigma=sigma, frame_size=M,
                       log2m=log2m)


@dataclass(frozen=True)
class GroupedTable:
    """Decode table of a frequency-grouped frame: the layout and one
    per-rank output table, as SearchTable has per dense id: `val` (the
    raw value of each rank), or `high`/`nb` (fold and escape coders), or
    neither when every rank is its own value (perm is the identity)."""

    layout: GroupLayout
    val: np.ndarray | None   # u32 (sigma,)
    high: np.ndarray | None  # u32 (sigma,)
    nb: np.ndarray | None    # u32 (sigma,)


def build_grouped_table(nfreqs: np.ndarray,
                        high_of_sym: np.ndarray | None = None,
                        nb_of_sym: np.ndarray | None = None) -> GroupedTable:
    layout = build_group_layout(nfreqs)
    _check_frame(layout.frame_size)
    perm = layout.perm
    if high_of_sym is not None:
        return GroupedTable(
            layout=layout, val=None,
            high=np.asarray(high_of_sym, dtype=np.uint32)[perm],
            nb=np.asarray(nb_of_sym, dtype=np.uint32)[perm])
    identity = bool((perm == np.arange(layout.sigma)).all())
    return GroupedTable(layout=layout, val=None if identity else perm,
                        high=None, nb=None)


def build_dec_table(nfreqs: np.ndarray,
                    high_of_sym: np.ndarray | None = None,
                    nb_of_sym: np.ndarray | None = None):
    """The decode table the prelude's frequencies select: GroupedTable
    past 2^13 live symbols, SearchTable below."""
    build = (build_grouped_table if use_grouped_layout(nfreqs)
             else build_search_table)
    return build(nfreqs, high_of_sym, nb_of_sym)


# Shared memory the direct engine's tables may take: the 227 KB a block
# can opt into on Hopper, less room for the kernel's scan scratch.
DIRECT_TABLE_BYTES = 227 * 1024 - 4096


@dataclass(frozen=True)
class SlotTable:
    """Per-slot decode table of a frame, for the direct engine: slot ->
    the index of its owning symbol in slot order (the dense id under the
    value-cumulative layout, the rank under the frequency-grouped one),
    and per index the symbol's frequency, first slot and output (value
    or high part, and exception-byte count)."""

    slot_sym: np.ndarray  # u16 (M,)
    freq: np.ndarray      # u32 (sigma,)
    base: np.ndarray      # u32 (sigma,) first slot of the symbol
    high: np.ndarray      # u32 (sigma,) value, or high part
    nb: np.ndarray        # u32 (sigma,) exception bytes (0 for values)
    sigma: int
    frame_size: int
    log2m: int


def _frame_of(table):
    """(sigma, M) of a SearchTable or a GroupedTable."""
    t = table.layout if isinstance(table, GroupedTable) else table
    return int(t.sigma), int(t.frame_size)


def direct_table_bytes(table) -> int:
    """Shared memory the direct engine needs for a decode table: a u16
    symbol index per slot and one 16-byte row per live symbol."""
    sigma, M = _frame_of(table)
    return 2 * M + 16 * sigma


def direct_fits(table) -> bool:
    """Whether the direct engine can decode this frame: its tables fit
    the shared memory of one block and its live symbols a u16 index."""
    sigma, _ = _frame_of(table)
    return (sigma <= 1 << 16
            and direct_table_bytes(table) <= DIRECT_TABLE_BYTES)


def materialize_slots(table) -> SlotTable:
    """The per-slot table of a SearchTable (slots in value order) or a
    GroupedTable (slots in rank order: symbol layout.perm[r] owns the
    r-th contiguous run)."""
    sigma, M = _frame_of(table)
    if sigma > 1 << 16:
        raise ValueError(f"{sigma} live symbols do not fit the direct "
                         f"engine's u16 symbol index")
    if isinstance(table, GroupedTable):
        lay = table.layout
        counts = np.diff(np.append(lay.g_rank0.astype(np.int64), sigma))
        freq = np.repeat(lay.g_f.astype(np.int64), counts)
        high = table.high if table.high is not None else table.val
        nb, log2m = table.nb, lay.log2m
    else:
        freq = np.diff(_bases(table.pivots, table.depth, M)[:sigma + 1])
        high = table.high if table.high is not None else table.val
        nb, log2m = table.nb, table.log2m
    if high is None:
        high = np.arange(sigma, dtype=np.uint32)
    if nb is None:
        nb = np.zeros(sigma, np.uint32)
    base = np.concatenate(([0], np.cumsum(freq)[:-1]))
    return SlotTable(
        slot_sym=np.repeat(np.arange(sigma, dtype=np.uint16), freq),
        freq=freq.astype(np.uint32), base=base.astype(np.uint32),
        high=np.asarray(high, dtype=np.uint32),
        nb=np.asarray(nb, dtype=np.uint32), sigma=sigma, frame_size=M,
        log2m=int(log2m))


# --------------------------------------------------------------------------
# device layout
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class EncDevice:
    """words: (sigma, 4) i32 rows [freq, base, magic (u32 bits), 0], one
    16-byte load per symbol in the encode scan."""

    words: torch.Tensor
    frame_size: int
    log2m: int


@dataclass(frozen=True)
class SearchDevice:
    """bases: (P+1,) i32, the present symbols' cumulative bases padded
    with M to P = 2^depth entries, then M once more (the upper bracket
    of the last symbol); level k of the bitwise search probes
    bases[(m << (k+1)) | (1 << k)].  high/nb: (sigma,) i32 per dense id;
    the decoded value is high[m] + (the nb exception bytes read).  A
    raw-value table rides in `high` with nb = 0, and the identity map is
    high = arange(sigma)."""

    bases: torch.Tensor
    high: torch.Tensor
    nb: torch.Tensor
    depth: int
    sigma: int
    frame_size: int
    log2m: int
    NR: int  # renorm rounds per step (max_renorm_rounds)
    NE: int  # exception rounds per step (max nb over the live symbols)


@dataclass(frozen=True)
class DirectDevice:
    """The direct decode's tables (K4).  slot_sym: (M,) i16 holding the
    u16 symbol index of each slot; rows: (sigma, 4) i32 rows [freq,
    base, high, nb], one 16-byte load per symbol.  The decoded value is
    high + (the nb exception bytes read)."""

    slot_sym: torch.Tensor
    rows: torch.Tensor
    sigma: int
    frame_size: int
    log2m: int
    NR: int
    NE: int


def _i32(a: np.ndarray, device) -> torch.Tensor:
    """u32/i32/i64 NumPy values -> i32 tensor with the same low 32 bits."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32)).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def _bases(pivots, depth: int, pad: int) -> np.ndarray:
    """(P+1,) search bases from pivot levels: level k of the bitwise
    search probes bases[(m << (k+1)) | (1 << k)]; entry 0 (the first
    bracket, never probed) is 0 and the rest is padded with `pad`."""
    P = 1 << depth
    bases = np.full(P + 1, pad, dtype=np.int64)
    bases[0] = 0
    for k, piv in enumerate(pivots):
        idx = (np.arange(P >> (k + 1)) << (k + 1)) + (1 << k)
        bases[idx] = np.asarray(piv, dtype=np.int64)
    return bases


def to_device(table, device):
    """Device tensors for an encode table (EncTable), a pivot-search
    table (SearchTable), a grouped decode table (GroupedTable) or a
    per-slot table (SlotTable).  Accepts this module's dataclasses or
    those of ans_tpu.ops.tables, which carry the same fields (and, for
    the encode table, a few the kernels do not read)."""
    device = torch.device(device)
    if isinstance(table, SlotTable):
        return _slots_to_device(table, device)
    if hasattr(table, "layout"):
        return _grouped_to_device(table, device)
    if hasattr(table, "pivots"):
        return _search_to_device(table, device)
    if hasattr(table, "magic"):
        sig = len(table.freq)
        words = np.zeros((sig, 4), dtype=np.uint32)
        words[:, 0] = table.freq
        words[:, 1] = table.base
        words[:, 2] = table.magic
        return EncDevice(words=_i32(words, device),
                         frame_size=int(table.frame_size),
                         log2m=int(table.log2m))
    raise TypeError(f"not an encode or decode table: {type(table)!r}")


def _search_to_device(st, device) -> SearchDevice:
    M = int(st.frame_size)
    bases = _bases(st.pivots, st.depth, M)
    if st.high is not None:
        high, nb = st.high, st.nb
    elif st.val is not None:
        high, nb = st.val, np.zeros(st.sigma, np.uint32)
    else:
        high, nb = (np.arange(st.sigma, dtype=np.uint32),
                    np.zeros(st.sigma, np.uint32))
    NE = int(np.max(nb)) if st.high is not None and st.sigma else 0
    return SearchDevice(bases=_i32(bases, device), high=_i32(high, device),
                        nb=_i32(nb, device), depth=int(st.depth),
                        sigma=int(st.sigma), frame_size=M,
                        log2m=int(st.log2m),
                        NR=max_renorm_rounds(int(st.log2m)), NE=NE)


def _slots_to_device(st: SlotTable, device) -> DirectDevice:
    rows = np.stack([st.freq, st.base, st.high, st.nb], axis=1)
    return DirectDevice(
        slot_sym=torch.from_numpy(st.slot_sym.view(np.int16).copy()).to(
            device),
        rows=_i32(rows, device), sigma=st.sigma, frame_size=st.frame_size,
        log2m=st.log2m, NR=max_renorm_rounds(st.log2m),
        NE=int(st.nb.max()) if st.sigma else 0)


@dataclass(frozen=True)
class GroupedEncDevice:
    """The grouped encode scan's tables (K6).  groups: (NG, 4) i32 rows
    [f, magic, slot0, rank0], one 16-byte load per group; bases: (P+1,)
    i32 rank boundaries g_rank0 laid out like SearchDevice.bases and
    padded with sigma; rank_of: (len(nfreqs),) i32 symbol -> rank, for
    scans fed symbol ids, or None for scans fed ranks."""

    groups: torch.Tensor
    bases: torch.Tensor
    rank_of: torch.Tensor | None
    depth: int
    sigma: int
    frame_size: int
    log2m: int


@dataclass(frozen=True)
class GroupedDecDevice:
    """The grouped decode's tables (K5).  groups: (NG, 4) i32 rows
    [f, magic, slot0, rank0]; bases: (P+1,) i32 slot boundaries g_slot0
    laid out like SearchDevice.bases and padded with M; table: (sigma,)
    i32 per-rank value or high part, or (0,) when the rank is the value;
    nb: (sigma,) u8 exception bytes per rank, or (0,) when NE = 0.  The
    decoded value is table[rank] (or rank) + the nb exception bytes.
    buckets, shift, levels: the short search of the kernel (bucket_table):
    buckets[slot >> shift] (i16 holding u16) is the group of the bucket's
    first slot, and `levels` probes over the boundaries finish it."""

    groups: torch.Tensor
    bases: torch.Tensor
    table: torch.Tensor
    nb: torch.Tensor
    depth: int
    sigma: int
    frame_size: int
    log2m: int
    NR: int
    NE: int
    buckets: torch.Tensor
    shift: int
    levels: int

    def group_bytes(self) -> int:
        """Shared memory K5 needs for the group rows, the boundaries its
        search may probe and the buckets."""
        NG = self.groups.shape[0]
        return 16 * NG + 4 * (NG + (1 << self.levels)) \
            + 2 * self.buckets.numel()

    def rank_table_bytes(self) -> int:
        """Bytes of the per-rank table and nb."""
        return 4 * self.table.numel() + self.nb.numel()


MAX_BUCKETS = 1024


def bucket_table(bounds: np.ndarray, span: int):
    """The top of a search over the sorted boundaries `bounds` (bounds[0]
    = 0) for keys 0..span-1, as one load: (first, shift, levels) where
    first[key >> shift] (u16, at most MAX_BUCKETS entries) is the last
    boundary index at or below the bucket's first key, and at most
    2^levels - 1 further boundaries lie inside any bucket, so `levels`
    probes (m + bit, bit = 2^(levels-1) .. 1, over bounds padded with
    span) end at the last boundary at or below the key."""
    bounds = np.asarray(bounds, dtype=np.int64)
    shift = max((span - 1).bit_length() - (MAX_BUCKETS - 1).bit_length(), 0)
    starts = np.arange(((span - 1) >> shift) + 1, dtype=np.int64) << shift
    ends = np.minimum(starts + (1 << shift), span) - 1
    first = np.searchsorted(bounds, starts, side="right") - 1
    last = np.searchsorted(bounds, ends, side="right") - 1
    return (first.astype(np.uint16), shift,
            int((last - first).max()).bit_length())


def _group_rows(layout, device) -> torch.Tensor:
    return _i32(np.stack([layout.g_f, layout.g_magic, layout.g_slot0,
                          layout.g_rank0], axis=1), device)


def grouped_enc_to_device(layout, device, *, rank_of: bool):
    """K6's tables for a GroupLayout (this module's or ans_tpu's):
    rank_of=True for a scan fed mapped symbol ids, False for ranks."""
    device = torch.device(device)
    return GroupedEncDevice(
        groups=_group_rows(layout, device),
        bases=_i32(_bases(layout.rank_pivots, layout.rank_depth,
                          layout.sigma), device),
        rank_of=_i32(layout.rank_of, device) if rank_of else None,
        depth=int(layout.rank_depth), sigma=int(layout.sigma),
        frame_size=int(layout.frame_size), log2m=int(layout.log2m))


def _grouped_to_device(gt: GroupedTable, device) -> GroupedDecDevice:
    lay = gt.layout
    table = gt.high if gt.high is not None else gt.val
    NE = int(np.max(gt.nb)) if gt.nb is not None else 0
    nb = np.asarray(gt.nb if NE else np.zeros(0), dtype=np.uint8)
    first, shift, levels = bucket_table(lay.g_slot0, int(lay.frame_size))
    return GroupedDecDevice(
        groups=_group_rows(lay, device),
        bases=_i32(_bases(lay.slot_pivots, lay.slot_depth, lay.frame_size),
                   device),
        table=_i32(table if table is not None else np.zeros(0), device),
        nb=torch.from_numpy(nb.copy()).to(device),
        depth=int(lay.slot_depth), sigma=int(lay.sigma),
        frame_size=int(lay.frame_size), log2m=int(lay.log2m),
        NR=max_renorm_rounds(int(lay.log2m)), NE=NE,
        buckets=torch.from_numpy(first.view(np.int16).copy()).to(device),
        shift=shift, levels=levels)
