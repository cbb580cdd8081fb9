"""Lane-format ("ATF" fmt 2) rANS engine in plain PyTorch: S lanes in
lockstep over one shared byte stream (docs/FORMAT.md section 2).

Counterpart of ans_tpu/ops/lane_codec.py.  Besides `lane_steps` and
`encode_totals` (the offset of every (step, round) pair, from which K2's
plain version places the bytes) this module holds the PLAIN VERSIONS of
the CUDA kernels: each computes the same function from the same inputs
as its kernel, with ordinary tensor ops.  The
kernels' wrappers (ops/encode.py, ops/place.py, ops/decode.py) run them
for tensors on the CPU, and chip_smoke.py holds each kernel against its
plain version on the card.

Layout: the symbol at position p = t*S + lane is handled by `lane` at
step t, so per-position arrays are staged (T, S).  u32 quantities travel
as i32 bit patterns and the plain versions compute in int64: torch has
no unsigned shifts, compares or division for 32-bit integers.

Byte rounds (six per step): renorm round j holds the j-th renorm byte
read by every lane needing more than j (lanes ascending), then exception
rounds likewise.  Within a round a lane's byte sits at round_base +
rank, where rank is the exclusive prefix of the round's mask over lanes.
Renorm and exception bytes are read high-first.
"""

from __future__ import annotations

import functools

import torch

from . import model_batch
from .tables import (A_L, DirectDevice, EncDevice, GroupedDecDevice,
                     GroupedEncDevice, SearchDevice)

NROUNDS = 6  # 3 renorm + 3 exception byte rounds per step


@functools.lru_cache(maxsize=64)
def batch_of_one(device: torch.device, *values: int) -> torch.Tensor:
    """The i64 array `values` on `device`, made once and kept: a batch of
    one's per-stream arrays (its length n; a decode's stream offsets
    [0, L] and n), which the batched kernels only read."""
    return torch.tensor(values, dtype=torch.int64).to(device)


def lane_steps(n: int, S: int) -> int:
    """Steps per lane T = ceil(n / S)."""
    return -(-n // S) if n else 0


def _valid(T: int, S: int, n: int, device) -> torch.Tensor:
    pos = (torch.arange(T, device=device, dtype=torch.int64)[:, None] * S
           + torch.arange(S, device=device, dtype=torch.int64)[None, :])
    return pos < n


def _round_masks(packed: torch.Tensor, nb: torch.Tensor, n: int):
    """(rc, nb) gated by validity, and the (T, S, 6) round masks."""
    T, S = packed.shape
    valid = _valid(T, S, n, packed.device)
    rc = torch.where(valid, (packed.to(torch.int64) >> 24) & 3, 0)
    nbv = torch.where(valid, nb.to(torch.int64), 0)
    j = torch.arange(3, device=packed.device)
    masks = torch.cat([rc[..., None] > j, nbv[..., None] > j], dim=-1)
    return rc, nbv, masks


def encode_totals(packed: torch.Tensor, nb: torch.Tensor, n: int):
    """Per-(step, round) byte offsets from the scan's packed words.

    Returns (round_base (T*6,) i64: the stream offset of every
    (step, round) pair, total 0-d i64 tensor: the stream length)."""
    _, _, masks = _round_masks(packed, nb, n)
    flat = masks.sum(dim=1).reshape(-1)
    incl = torch.cumsum(flat, 0)
    return incl - flat, flat.sum()


# --------------------------------------------------------------------------
# plain versions of the kernels
# --------------------------------------------------------------------------

def encode_scan_plain(syms: torch.Tensor, n: int, table: EncDevice):
    """Plain version of K1 (csrc/encode_scan.cu): the reverse rANS scan.

    syms: (T, S) i32 mapped symbol ids.  Returns (packed (T, S) i32,
    states (S,) i32).  packed = r0 | r1<<8 | r2<<16 | rc<<24, where byte
    slot i holds the low byte of the state after the first i conditional
    renorm shifts (emitted or not) and rc counts the emitted bytes."""
    T, S = syms.shape
    valid = _valid(T, S, n, syms.device)
    s = torch.where(valid, syms.to(torch.int64), 0)
    words = table.words.to(torch.int64) & 0xFFFFFFFF
    return _scan(words[s, 0], words[s, 1], valid, table.log2m)


def encode_scan_grouped_plain(syms: torch.Tensor, n: int,
                              table: GroupedEncDevice):
    """Plain version of K6 (csrc/encode_scan_grouped.cu): the reverse
    rANS scan in rank space under the frequency-grouped layout.

    syms: (T, S) i32 ranks, or symbol ids when table.rank_of is given
    (rank = rank_of[sym & 0xFFFFFF]).  The group of a rank is found by
    `torch.searchsorted` over the group rank boundaries (the kernel runs
    a bitwise binary search), and base = slot0 + (rank - rank0) * f.
    Returns (packed, states) as encode_scan_plain does.  Raises
    ValueError when a symbol or a rank lies outside the tables."""
    T, S = syms.shape
    valid = _valid(T, S, n, syms.device)
    r = torch.where(valid, syms.to(torch.int64), 0)
    if table.rank_of is not None:
        r = r & 0xFFFFFF
        if bool((r >= table.rank_of.numel()).any()):
            raise ValueError("encode_scan_grouped: a symbol or rank lies "
                             "outside the table")
        r = torch.where(valid, table.rank_of.to(torch.int64)[r], 0)
    if bool(((r < 0) | (r >= table.sigma)).any()):
        raise ValueError("encode_scan_grouped: a symbol or rank lies "
                         "outside the table")
    m = torch.searchsorted(table.bases[:-1].to(torch.int64), r,
                           right=True) - 1
    rows = table.groups.to(torch.int64)[m] & 0xFFFFFFFF
    f = rows[..., 0]
    return _scan(f, rows[..., 2] + (r - rows[..., 3]) * f, valid,
                 table.log2m)


def _scan(freq: torch.Tensor, base: torch.Tensor, valid: torch.Tensor,
          log2m):
    """The reverse scan of K1 and K6 over (..., T, S) int64 per-position
    frequencies and slot bases (pad positions are masked by `valid`);
    log2m an int, or a tensor of one a stream shaped (..., 1)."""
    T, S = freq.shape[-2:]
    f_all = freq.clamp(min=1)  # an absent symbol codes as freq 1
    state = torch.full(freq.shape[:-2] + (S,), A_L, dtype=torch.int64,
                       device=freq.device)
    packed = torch.empty(freq.shape, dtype=torch.int32, device=freq.device)
    for t in range(T - 1, -1, -1):
        v, f = valid[..., t, :], f_all[..., t, :]
        ub = f << (31 - log2m)
        st = state
        word = torch.zeros_like(st)
        rc = torch.zeros_like(st)
        for i in range(3):
            e = v & (st >= ub)
            word |= (st & 0xFF) << (8 * i)
            rc += e
            st = torch.where(e, st >> 8, st)
        q = st // f
        new = (q << log2m) + (st - q * f) + base[..., t, :]
        state = torch.where(v, new, state)
        packed[..., t, :] = (word | (rc << 24)).to(torch.int32)
    return packed, state.to(torch.int32)


def place_plain(packed: torch.Tensor, nb: torch.Tensor, excw: torch.Tensor,
                n: int, total: int | None = None):
    """Plain version of K2 (csrc/place.cu): the round totals
    (encode_totals), then the packed words and exception bytes placed
    into the fmt-2 stream.

    packed/nb/excw: (T, S) i32 (excw holds the three low bytes of each
    value, lowest first).  Returns (stream (total,) u8, step_base (T,)
    i64: the stream offset of each step, total: the stream's length).
    Raises ValueError when `total` is given and the words add up to
    another length."""
    T, S = packed.shape
    round_base, got = encode_totals(packed, nb, n)
    got = int(got)
    if total is not None and got != total:
        raise ValueError(f"place: the words hold {got} bytes, not the "
                         f"{total} of the section plan")
    rc, nbv, masks = _round_masks(packed, nb, n)
    mi = masks.to(torch.int64)
    rank = torch.cumsum(mi, dim=1) - mi
    pos = round_base.reshape(T, 1, NROUNDS) + rank
    j = torch.arange(3, device=packed.device)
    # round j reads emission slot rc-1-j (renorm) / nb-1-j (exception)
    rsh = 8 * (rc[..., None] - 1 - j).clamp(min=0)
    esh = 8 * (nbv[..., None] - 1 - j).clamp(min=0)
    rbytes = (packed.to(torch.int64)[..., None] >> rsh) & 0xFF
    ebytes = (excw.to(torch.int64)[..., None] >> esh) & 0xFF
    byte = torch.cat([rbytes, ebytes], dim=-1)
    stream = torch.zeros(got, dtype=torch.uint8, device=packed.device)
    stream[pos[masks]] = byte[masks].to(torch.uint8)
    return stream, round_base[::NROUNDS].contiguous(), got


def decode_search_plain(stream: torch.Tensor, states: torch.Tensor,
                        table: SearchDevice, n: int, T: int) -> torch.Tensor:
    """Plain version of K3 (csrc/decode_search.cu): lockstep decode with
    the symbol found by `torch.searchsorted` over the present symbols'
    bases (the kernel runs a bitwise binary search instead).

    stream: (L,) u8 concatenated payload; states: (S,) i32 final encoder
    states.  Returns (T, S) i32 bit patterns of the decoded u32 values
    (positions >= n hold don't-care values).  Raises ValueError when a
    read would pass the end of the stream (a corrupt blob)."""
    M = table.frame_size
    bases = table.bases.to(torch.int64)
    search = bases[:-1].contiguous()
    high = table.high.to(torch.int64) & 0xFFFFFFFF
    nbt = table.nb.to(torch.int64)

    def symbol(state):
        slot = state & (M - 1)
        m = torch.searchsorted(search, slot, right=True) - 1
        lb, ub = bases[m], bases[m + 1]
        return ((ub - lb) * (state >> table.log2m) + slot - lb, nbt[m],
                high[m])

    return _decode_plain(stream, states, n, T, table.NR, table.NE, symbol)


def decode_grouped_plain(stream: torch.Tensor, states: torch.Tensor,
                         table: GroupedDecDevice, n: int,
                         T: int) -> torch.Tensor:
    """Plain version of K5 (csrc/decode_grouped.cu): lockstep decode of
    a frequency-grouped frame.  The group comes from `torch.searchsorted`
    over the group slot boundaries and the in-group index from an exact
    integer division (the kernel runs a bitwise binary search and a
    multiply-high); rank = rank0 + j.  The value is table[rank] (or the
    rank itself when the table is empty) plus the exception bytes.
    Arguments, result and errors as decode_search_plain."""
    M = table.frame_size
    search = table.bases[:-1].to(torch.int64)
    rows = table.groups.to(torch.int64) & 0xFFFFFFFF
    out = table.table.to(torch.int64) & 0xFFFFFFFF
    nbt = table.nb.to(torch.int64)

    def symbol(state):
        slot = state & (M - 1)
        g = rows[torch.searchsorted(search, slot, right=True) - 1]
        f = g[:, 0]
        x = slot - g[:, 2]
        j = x // f
        rank = g[:, 3] + j
        st0 = f * (state >> table.log2m) + x - j * f
        return (st0, nbt[rank] if table.NE else None,
                out[rank] if out.numel() else rank)

    return _decode_plain(stream, states, n, T, table.NR, table.NE, symbol)


def bucket_search(table: GroupedDecDevice,
                  slot: torch.Tensor) -> torch.Tensor:
    """The group of each slot (int64) by the short search K5 runs: the
    bucket's first group, then table.levels probes m + bit over the NG
    boundaries padded with M.  decode_grouped_plain keeps the full search;
    this is the kernel's, for the tests that hold the two equal."""
    NG = table.groups.shape[0]
    bounds = torch.cat([
        table.bases[:NG].to(torch.int64),
        torch.full((1 << table.levels,), table.frame_size,
                   dtype=torch.int64, device=slot.device)])
    m = table.buckets.to(torch.int64)[slot >> table.shift] & 0xFFFF
    for k in range(table.levels - 1, -1, -1):
        probe = m + (1 << k)
        m = torch.where(slot >= bounds[probe], probe, m)
    return m


def decode_direct_plain(stream: torch.Tensor, states: torch.Tensor,
                        table: DirectDevice, n: int, T: int) -> torch.Tensor:
    """Plain version of K4 (csrc/decode_direct.cu): lockstep decode with
    the symbol read from the per-slot table (slot -> symbol index ->
    row [freq, base, high, nb]), under either slot layout.  Arguments,
    result and errors as decode_search_plain."""
    M = table.frame_size
    slot_sym = table.slot_sym.to(torch.int64) & 0xFFFF
    rows = table.rows.to(torch.int64) & 0xFFFFFFFF

    def symbol(state):
        slot = state & (M - 1)
        r = rows[slot_sym[slot]]
        return (r[:, 0] * (state >> table.log2m) + slot - r[:, 1],
                r[:, 3] if table.NE else None, r[:, 2])

    return _decode_plain(stream, states, n, T, table.NR, table.NE, symbol)


# --------------------------------------------------------------------------
# the plain version of the batched placement: D streams, one after the other
# --------------------------------------------------------------------------

def place_batch_plain(packed: torch.Tensor, nb: torch.Tensor,
                      excw: torch.Tensor, n: torch.Tensor):
    """The placements of D streams by place_plain, one after the other in
    one buffer: packed/nb/excw (D, T, S), n (D,) i64.  Returns (stream u8,
    offsets (D, T + 1) i64: the offset of each step of each stream in
    `stream`, then that stream's end)."""
    D, T, _ = packed.shape
    parts, at = [], 0
    offsets = torch.zeros((D, T + 1), dtype=torch.int64,
                          device=packed.device)
    for d, nd in enumerate(n.tolist()):
        stream, step_base, got = place_plain(packed[d], nb[d], excw[d],
                                             int(nd))
        parts.append(stream)
        offsets[d, :T] = at + step_base
        at += got
        offsets[d, T] = at
    return torch.cat(parts), offsets


# --------------------------------------------------------------------------
# the plain versions of the batched kernels as the kernels see a batch: the
# D streams at once, stream d's table read out of the batch's concatenated
# tables at its row's offsets (ops/model_batch.py), whether the streams
# share one model (one row) or have one each
# --------------------------------------------------------------------------

_PAD = 1 << 62  # past every key of a search


def _column(batch, name: str, D: int, device) -> torch.Tensor:
    """A model field of each of the D streams, (D,) int64 on `device`."""
    col = batch.column(name)
    if batch.shared:
        col = col.repeat(D)
    return torch.from_numpy(col).to(device)


def _padded(cat: torch.Tensor, off: torch.Tensor,
            length: torch.Tensor) -> torch.Tensor:
    """Each stream's sorted part cat[off[d]:off[d] + length[d]] as a row of
    a (D, max length) int64 matrix, padded past every key."""
    width = max(int(length.max()), 1)
    at = torch.arange(width, device=off.device)
    inside = at[None, :] < length[:, None]
    idx = torch.where(inside, off[:, None] + at[None, :], 0)
    return torch.where(inside, cat.to(torch.int64)[idx], _PAD)


def _valid_batch(D: int, T: int, S: int, n: torch.Tensor) -> torch.Tensor:
    pos = (torch.arange(T, device=n.device, dtype=torch.int64)[:, None] * S
           + torch.arange(S, device=n.device, dtype=torch.int64)[None, :])
    return pos[None] < n[:, None, None]


def encode_scan_batch_plain(syms: torch.Tensor, n: torch.Tensor, table):
    """Plain version of K1 on a batch: syms (D, T, S) i32, n (D,) i64,
    table an EncDevice the streams share or a ModelBatch of one a stream.
    Returns (packed (D, T, S) i32, states (D, S) i32), as encode_scan_plain
    on each stream; raises ValueError when a symbol lies outside its
    stream's table."""
    batch = model_batch.of(table)
    D, T, S = syms.shape
    dev = syms.device
    valid = _valid_batch(D, T, S, n)
    s = torch.where(valid, syms.to(torch.int64) & 0xFFFFFFFF, 0)
    sigma = _column(batch, "words_len", D, dev)[:, None, None]
    if bool((s >= sigma).any()):
        raise ValueError("encode_scan: a symbol lies outside the table")
    words = batch.tensors["words"].to(torch.int64) & 0xFFFFFFFF
    rows = words[_column(batch, "words_off", D, dev)[:, None, None] + s]
    return _scan(rows[..., 0], rows[..., 1], valid,
                 _column(batch, "log2m", D, dev)[:, None])


def encode_scan_grouped_batch_plain(syms: torch.Tensor, n: torch.Tensor,
                                    table):
    """Plain version of K6 on a batch (table a GroupedEncDevice or a
    ModelBatch of them): the streams' ranks, or symbol ids mapped through
    their own rank_of, searched in their own group rank boundaries
    (torch.searchsorted).  Result and errors as
    encode_scan_grouped_plain on each stream."""
    batch = model_batch.of(table)
    D, T, S = syms.shape
    dev = syms.device
    col = functools.partial(_column, batch, D=D, device=dev)
    valid = _valid_batch(D, T, S, n)
    r = torch.where(valid, syms.to(torch.int64), 0)
    ro_off = col("rank_of_off")[:, None, None]
    has = ro_off >= 0
    if bool(has.any()):
        sym = r & 0xFFFFFF
        if bool((has & (sym >= col("rank_of_len")[:, None, None])).any()):
            raise ValueError("encode_scan_grouped: a symbol or rank lies "
                             "outside the table")
        rank_of = batch.tensors["rank_of"].to(torch.int64)
        ranks = rank_of[torch.where(has, ro_off + sym, 0)]
        r = torch.where(has, torch.where(valid, ranks, 0), r)
    if bool(((r < 0) | (r >= col("sigma")[:, None, None])).any()):
        raise ValueError("encode_scan_grouped: a symbol or rank lies "
                         "outside the table")
    bounds = _padded(batch.tensors["bases"], col("bases_off"),
                     col("bases_len") - 1)
    m = torch.searchsorted(bounds, r.reshape(D, -1), right=True) - 1
    groups = batch.tensors["groups"].to(torch.int64) & 0xFFFFFFFF
    rows = groups[col("groups_off")[:, None] + m].reshape(D, T, S, 4)
    f = rows[..., 0]
    return _scan(f, rows[..., 2] + (r - rows[..., 3]) * f, valid,
                 col("log2m")[:, None])


def decode_search_batch_plain(stream: torch.Tensor, stream_off: torch.Tensor,
                              states: torch.Tensor, n: torch.Tensor, table,
                              T: int) -> torch.Tensor:
    """Plain version of K3 on a batch: stream b is stream[stream_off[b]:
    stream_off[b + 1]], states (D, S) i32, n (D,) i64, table a SearchDevice
    the streams share or a ModelBatch of one a stream.  Returns (D, T, S)
    i32 as decode_search_plain on each stream (a stream with n = 0 holds
    zeros); raises ValueError when a read passes the end of its stream."""
    batch = model_batch.of(table)
    D = states.shape[0]
    col = functools.partial(_column, batch, D=D, device=states.device)
    bases = batch.tensors["bases"].to(torch.int64)
    high = batch.tensors["high"].to(torch.int64) & 0xFFFFFFFF
    nbt = batch.tensors["nb"].to(torch.int64)
    boff, hoff, noff = (col("bases_off")[:, None], col("high_off")[:, None],
                        col("nb_off")[:, None])
    log2m = col("log2m")[:, None]
    search = _padded(batch.tensors["bases"], boff[:, 0],
                     col("bases_len") - 1)
    has_nb = bool(batch.largest("NE"))

    def symbol(state):
        slot = state & ((1 << log2m) - 1)
        m = torch.searchsorted(search, slot, right=True) - 1
        lb, ub = bases[boff + m], bases[boff + m + 1]
        return ((ub - lb) * (state >> log2m) + slot - lb,
                nbt[noff + m] if has_nb else None, high[hoff + m])

    return _decode_batch(stream, stream_off, states, n, T, col("NR"),
                         symbol)


def decode_direct_batch_plain(stream: torch.Tensor, stream_off: torch.Tensor,
                              states: torch.Tensor, n: torch.Tensor, table,
                              T: int) -> torch.Tensor:
    """Plain version of K4 on a batch (table a DirectDevice or a ModelBatch
    of them); arguments, result and errors as decode_search_batch_plain."""
    batch = model_batch.of(table)
    D = states.shape[0]
    col = functools.partial(_column, batch, D=D, device=states.device)
    slot_sym = batch.tensors["slot_sym"].to(torch.int64) & 0xFFFF
    rows = batch.tensors["rows"].to(torch.int64) & 0xFFFFFFFF
    soff, roff = col("slot_sym_off")[:, None], col("rows_off")[:, None]
    log2m = col("log2m")[:, None]
    has_nb = bool(batch.largest("NE"))

    def symbol(state):
        slot = state & ((1 << log2m) - 1)
        r = rows[roff + slot_sym[soff + slot]]
        return (r[..., 0] * (state >> log2m) + slot - r[..., 1],
                r[..., 3] if has_nb else None, r[..., 2])

    return _decode_batch(stream, stream_off, states, n, T, col("NR"),
                         symbol)


def decode_grouped_batch_plain(stream: torch.Tensor,
                               stream_off: torch.Tensor,
                               states: torch.Tensor, n: torch.Tensor, table,
                               T: int) -> torch.Tensor:
    """Plain version of K5 on a batch (table a GroupedDecDevice or a
    ModelBatch of them: each stream's per-rank table or none, and
    exception bytes or none); arguments, result and errors as
    decode_search_batch_plain."""
    batch = model_batch.of(table)
    D = states.shape[0]
    col = functools.partial(_column, batch, D=D, device=states.device)
    groups = batch.tensors["groups"].to(torch.int64) & 0xFFFFFFFF
    values = batch.tensors["table"].to(torch.int64) & 0xFFFFFFFF
    nbt = batch.tensors["nb"].to(torch.int64)
    goff, log2m = col("groups_off")[:, None], col("log2m")[:, None]
    toff, noff = col("table_off")[:, None], col("nb_off")[:, None]
    has_table = col("table_len")[:, None] > 0
    has_nb = col("NE")[:, None] > 0
    search = _padded(batch.tensors["bases"], col("bases_off"),
                     col("bases_len") - 1)

    def symbol(state):
        slot = state & ((1 << log2m) - 1)
        g = groups[goff + torch.searchsorted(search, slot, right=True) - 1]
        f = g[..., 0]
        x = slot - g[..., 2]
        j = x // f
        rank = g[..., 3] + j
        st0 = f * (state >> log2m) + x - j * f
        nb = (torch.where(has_nb, nbt[torch.where(has_nb, noff + rank, 0)],
                          0) if nbt.numel() else None)
        high = (torch.where(has_table,
                            values[torch.where(has_table, toff + rank, 0)],
                            rank) if values.numel() else rank)
        return st0, nb, high

    return _decode_batch(stream, stream_off, states, n, T, col("NR"),
                         symbol)


def _decode_batch(stream, stream_off, states, n, T: int, NR, symbol):
    """The lockstep loop of K3, K4 and K5 over the D streams of a batch at
    once: each stream's lanes rank their reads in its own rounds (its own
    NR renorm rounds, the exception rounds its symbols read), one cursor a
    stream.  symbol(state) gives each lane's (D, S) state before
    renormalisation, exception-byte count (None when no frame has any) and
    the value's high part."""
    D, S = states.shape
    dev = states.device
    # stream b is stream[stream_off[b]:stream_off[b + 1]], cut as a slice
    # is cut at the buffer's end
    start = stream_off[:-1].clamp(max=stream.numel())[:, None, None]
    length = (stream_off[1:].clamp(max=stream.numel())[:, None, None]
              - start).clamp(min=0)
    # one zero byte past the end takes the (flagged) out-of-range reads
    src = torch.cat([stream.to(torch.int64),
                     torch.zeros(1, dtype=torch.int64, device=dev)])
    lanes = torch.arange(S, device=dev, dtype=torch.int64)
    j = torch.arange(3, device=dev)
    thr = torch.where(j[None, :] < NR[:, None], torch.tensor(
        [A_L >> (8 * k) for k in range(3)], device=dev)[None, :], 0)
    state = states.to(torch.int64) & 0xFFFFFFFF
    cursor = torch.zeros((D, 1, 1), dtype=torch.int64, device=dev)
    overrun = torch.zeros((), dtype=torch.bool, device=dev)
    out = torch.empty((D, T, S), dtype=torch.int32, device=dev)
    for t in range(T):
        valid = t * S + lanes[None, :] < n[:, None]
        st0, nb, high = symbol(state)
        st0 = torch.where(valid, st0, state)
        rc = torch.where(valid, (st0[..., None] < thr[:, None, :]).sum(-1),
                         0)
        masks = rc[..., None] > j
        if nb is not None:
            masks = torch.cat([masks, torch.where(valid, nb, 0)[..., None]
                               > j], -1)
        mi = masks.to(torch.int64)
        tot = mi.sum(1, keepdim=True)
        pos = cursor + (torch.cumsum(tot, -1) - tot) + torch.cumsum(mi, 1) \
            - mi
        overrun |= (masks & (pos >= length)).any()
        byte = src[torch.where(masks & (pos < length), start + pos,
                               stream.numel())]
        st = st0
        for k in range(3):
            st = torch.where(masks[..., k], (st << 8) | byte[..., k], st)
        low = torch.zeros_like(st)
        for k in range(3, masks.shape[-1]):
            low = torch.where(masks[..., k], (low << 8) | byte[..., k], low)
        out[:, t] = ((high + low) & 0xFFFFFFFF).to(torch.int32)
        state = st
        cursor = cursor + tot.sum(-1, keepdim=True)
    if bool(overrun):
        raise ValueError("corrupt lane stream: a read passes the end of "
                         "the stream")
    out[n == 0] = 0
    return out


def _decode_plain(stream, states, n: int, T: int, NR: int, NE: int,
                  symbol) -> torch.Tensor:
    """The lockstep loop of K3, K4 and K5.  symbol(state) gives each lane's
    state before renormalisation, its exception-byte count (None when
    NE = 0) and the value's high part; this loop ranks every round's
    byte reads over the lanes, merges the bytes high-first and advances
    one cursor over the whole stream."""
    S = states.numel()
    dev = states.device
    L = stream.numel()
    # one zero byte past the end takes the (flagged) out-of-range reads
    src = torch.cat([stream.to(torch.int64),
                     torch.zeros(1, dtype=torch.int64, device=dev)])
    lanes = torch.arange(S, device=dev, dtype=torch.int64)
    j = torch.arange(3, device=dev)
    thr = torch.tensor([A_L >> (8 * k) for k in range(NR)],
                       dtype=torch.int64, device=dev)
    state = states.to(torch.int64) & 0xFFFFFFFF
    cursor = torch.zeros((), dtype=torch.int64, device=dev)
    overrun = torch.zeros((), dtype=torch.bool, device=dev)
    out = torch.empty((T, S), dtype=torch.int32, device=dev)
    for t in range(T):
        valid = t * S + lanes < n
        st0, nb, high = symbol(state)
        st0 = torch.where(valid, st0, state)
        rc = torch.where(valid, (st0[:, None] < thr).sum(1), 0)
        masks = rc[:, None] > j[:NR]
        if NE:
            nb = torch.where(valid, nb, 0)
            masks = torch.cat([masks, nb[:, None] > j[:NE]], 1)
        mi = masks.to(torch.int64)
        tot = mi.sum(0)
        pos = cursor + (torch.cumsum(tot, 0) - tot) + torch.cumsum(mi, 0) - mi
        overrun |= (masks & (pos >= L)).any()
        byte = src[torch.where(masks, pos, L).clamp(max=L)]
        st = st0
        for k in range(NR):
            st = torch.where(masks[:, k], (st << 8) | byte[:, k], st)
        low = torch.zeros_like(st)
        for k in range(NR, NR + NE):
            low = torch.where(masks[:, k], (low << 8) | byte[:, k], low)
        out[t] = ((high + low) & 0xFFFFFFFF).to(torch.int32)
        state = st
        cursor = cursor + tot.sum()
    if bool(overrun):
        raise ValueError("corrupt lane stream: a read passes the end of "
                         "the stream")
    return out
