"""Lane-engine ANS codecs on PyTorch (counterpart of ans_tpu/models/ans.py):
AnsFold (ANSfold-1..8), AnsInt (ANS, and ANSsint-h: the reference's
ans_sint.hpp is AnsInt with its H_approx knob exposed), AnsMsb (ANSmsb, and
ANSsmsb-h likewise) and AnsReorderFold (ANSrfold-1..8).

Pipeline per block (two-pass semi-static):
  1. mapping + exception extraction + histogram  - device fold or msb
     map (ops.mappings) or host tail escape (ops.escape); rfold first
     remaps the most frequent values on the host
  2. adjust_freqs frame search                    - host float64
     (reference_model.model, the port's copy of ans_tpu's)
  3. prelude serialization                        - host, likewise
  4. S-lane stream coding                         - device: the encode scan
     (K1, or K6 under the frequency-grouped layout) and placement (K2)

The wire format is the lane format of docs/FORMAT.md: compat method
header + prelude, then the fmt-2 lane stream (rfold's reorder header
comes first).  Frames with more than 2^13 live symbols use the
frequency-grouped slot layout (ops/grouped.py); the identity coders fold
huge alphabets with the tail escape first.  Both choices are pure
functions of the prelude, so decoders re-derive them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (A_MAX_FRAME_LOG2, MSB_MAX_SIGMA, fold_max_sigma,
                         fold_threshold)
from ..ops import escape, grouped, lane_codec, tables
from ..ops.mappings import fold_map_hist, msb_map_hist
from ..reference_model import mappings as map_np
from ..reference_model.model import (adjust_freqs, load_prelude,
                                     serialize_prelude)
from . import config, engine, framing

# default frame cap: None = the reference's exact adjust_freqs search,
# bounded only by the lane format's own frame ceiling
DEFAULT_MAX_FRAME = None
LANE_FRAME_LIMIT = 1 << A_MAX_FRAME_LOG2


def lane_frame_cap(max_frame: int | None) -> int:
    return LANE_FRAME_LIMIT if max_frame is None else max_frame


def _stage_ts(mapped: torch.Tensor, nb: torch.Tensor, low: torch.Tensor,
              n: int, S: int, T: int):
    """Pad the (n,) i32 encode inputs with zeros to (T, S) lane order."""
    def stage(x):
        out = torch.zeros(T * S, dtype=torch.int32, device=x.device)
        out[:n] = x
        return out.reshape(T, S)
    return stage(mapped), stage(nb), stage(low)


def scan_table(ffreqs, raw: bool, device):
    """The encode scan's device table of a frame, and the value -> rank
    map (an (sigma,) i32 device tensor) that a `raw` coder's symbols go
    through first, or None.

    The frame's frequencies select the slot layout (a format decision
    both coder sides derive identically).  Value-cumulative: K1's
    per-symbol table.  Frequency-grouped: K6's group tables; `raw` coders
    (their symbols are the values themselves) gather each value's rank on
    the device, the others leave the symbol -> rank map to the kernel."""
    if not grouped.use_grouped_layout(ffreqs):
        return tables.to_device(tables.build_enc_table(ffreqs), device), None
    layout = grouped.build_group_layout(ffreqs)
    table = tables.grouped_enc_to_device(layout, device, rank_of=not raw)
    if not raw:
        return table, None
    return table, torch.from_numpy(layout.rank_of.view(np.int32)).to(device)


def to_ranks(mapped: torch.Tensor, rank_of) -> torch.Tensor:
    """A raw coder's symbols as their ranks (scan_table's map), or the
    symbols themselves when there is no map."""
    if rank_of is None:
        return mapped
    return rank_of[mapped.to(torch.int64) & 0xFFFFFFFF]


def _stage(mapped, nb, low, n: int, ffreqs, raw: bool, S: int):
    """The encode scan's table (scan_table) and the (T, S) staged
    inputs."""
    T = lane_codec.lane_steps(n, S)
    table, rank_of = scan_table(ffreqs, raw, mapped.device)
    return table, _stage_ts(to_ranks(mapped, rank_of), nb, low, n, S, T)


def _to_device(values, device) -> torch.Tensor:
    """Host u32 values -> (n,) i32 bit patterns on `device`."""
    values = np.ascontiguousarray(values, dtype=np.uint32)
    if len(values) == 0:
        raise ValueError("cannot encode an empty sequence")
    return torch.from_numpy(values.view(np.int32)).to(device)


class _LaneCodec:
    """What the lane codecs share: a subclass gives `_enc_inputs` (the
    model half of encode: mapped symbols, exception counts and low bytes
    on the device, the prelude and frame frequencies, whether the symbols
    are raw values, and the header bytes in front of the prelude) and
    `_table` (the decode table of a prelude's frequencies); one with
    another prelude than the ANS family's overrides `_prelude` and
    `_dec_table`."""

    def _prelude(self, pfreqs) -> bytes:
        """The wire prelude of the model's frequencies."""
        return serialize_prelude(pfreqs, int(pfreqs.sum()))

    def encode(self, values) -> bytes:
        """Model half -> prelude -> lane stream.  The prelude serialises
        the true per-symbol frequencies (pfreqs); the frame runs over
        ffreqs, which differ only under the tail escape."""
        mapped, k, low, pfreqs, ffreqs, raw, header = self._enc_inputs(
            values)
        n = int(mapped.shape[0])
        table, staged = _stage(mapped, k, low, n, ffreqs, raw,
                               self.lanes or config.default_lane_count(n))
        return (header + self._prelude(pfreqs)
                + engine.encode(*staged, n, table))

    def _dec_table(self, buf: bytes):
        """(decode table, stream offset) parsed from the wire prelude."""
        nfreqs, plen = load_prelude(buf)
        return self._table(nfreqs), plen

    def prepare_decoder(self, buf: bytes, n: int,
                        engine_name: str | None = None):
        """Stage a blob for repeated decodes on the codec's device: an
        engine.PreparedDecoder on `engine_name` ("search", "grouped" or
        "direct"; None: the engine rule's choice)."""
        table, off = self._dec_table(buf)
        S, states, payload, _, sec_len = framing.parse(buf, off)
        return engine.PreparedDecoder(
            payload, states, table, n, S=S, T=lane_codec.lane_steps(n, S),
            sec_len=sec_len, device=self.device, engine=engine_name)

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        prep = self.prepare_decoder(buf, n)
        return prep.to_host(prep())


class AnsInt(_LaneCodec):
    """Large-alphabet rANS directly over u32 symbols (reference:
    ans_int.hpp:38-306), S-lane stream, run on `device`."""

    def __init__(self, h_approx: int = 1, lanes: int | None = None,
                 max_frame: int | None = DEFAULT_MAX_FRAME, *, device):
        self.h_approx = h_approx
        self.lanes = config.validate_lanes(lanes)
        self.max_frame = max_frame
        self.device = torch.device(device)
        self.name = "ANS" if h_approx == 1 else f"ANSsint-{h_approx}"

    def _enc_inputs(self, values):
        """(mapped, k, low, prelude_freqs, frame_freqs, raw, header): the
        model half of encode(), shared with models.prepare_encoder.  The
        first three are (n,) i32 device tensors; no header.  Huge live
        alphabets take the tail escape (the frame then runs over the
        folded alphabet, the prelude keeps the true vector); otherwise
        mapped holds the raw values (raw=True)."""
        x = _to_device(values, self.device)
        values = np.ascontiguousarray(values, dtype=np.uint32)
        max_sym = int(values.max())
        freqs = np.bincount(values, minlength=max_sym + 1).astype(np.uint64)
        nfreqs = adjust_freqs(freqs, max_sym, False, self.h_approx,
                              lane_frame_cap(self.max_frame))
        plan = escape.plan_from_freqs(nfreqs)
        if plan is not None:
            mapped, k, _ = plan.map_values(values)
            return (_to_device(mapped, self.device),
                    _to_device(k, self.device), x & 0xFFFFFF, nfreqs,
                    plan.frame_freqs, False, b"")
        zero = torch.zeros_like(x)
        return x, zero, zero, nfreqs, nfreqs, True, b""

    def _table(self, nfreqs):
        """The decode table of a prelude's frequencies: the tail escape's
        folded alphabet when the frequencies select it (the derivation
        the encoder ran), their own alphabet otherwise; grouped or pivot
        search by the live alphabet of the frame that was coded."""
        plan = escape.plan_from_freqs(nfreqs)
        if plan is not None:
            return tables.build_dec_table(plan.frame_freqs, plan.sym_high,
                                          plan.sym_nb)
        return tables.build_dec_table(nfreqs)


def _mapped_inputs(codec, mapped_hist, header: bytes = b""):
    """The model half of a device-mapped coder's encode (fold, msb,
    rfold): (mapped, k, low, nfreqs, nfreqs, raw=False, header) from the
    device pass's (mapped, k, low, hist); the frame search runs on the
    histogram with the byte-oriented frame rule."""
    mapped, k, low, hist = mapped_hist
    freqs = hist.cpu().numpy().astype(np.uint64)
    max_sym = int(np.flatnonzero(freqs)[-1])
    nfreqs = adjust_freqs(freqs, max_sym, True, codec.h_approx,
                          lane_frame_cap(codec.max_frame))
    return mapped, k, low, nfreqs, nfreqs, False, header


class AnsFold(_LaneCodec):
    """Generalized byte-fold rANS, fidelity 1..8 (reference:
    ans_fold.hpp:38-311), S-lane stream, run on `device`."""

    def __init__(self, fidelity: int, h_approx: int = 1,
                 lanes: int | None = None,
                 max_frame: int | None = DEFAULT_MAX_FRAME, *, device):
        if not 1 <= fidelity <= 8:
            raise ValueError(f"fidelity must be in 1..8, got {fidelity}")
        self.fidelity = fidelity
        self.h_approx = h_approx
        self.lanes = config.validate_lanes(lanes)
        self.max_frame = max_frame
        self.device = torch.device(device)
        self.name = f"ANSfold-{fidelity}"

    def _enc_inputs(self, values):
        """(mapped, k, low, nfreqs, nfreqs, raw=False, header=b""): the
        model half of encode(), as AnsInt._enc_inputs; the mapping runs on
        the device."""
        return _mapped_inputs(self, fold_map_hist(
            _to_device(values, self.device), fidelity=self.fidelity,
            length=fold_max_sigma(self.fidelity)))

    def _table(self, nfreqs):
        """The decode table of a prelude's frequencies (grouped past 2^13
        live symbols, pivot search below)."""
        syms = np.arange(len(nfreqs), dtype=np.uint32)
        high, nb = map_np.fold_unmap_high(syms, self.fidelity)
        return tables.build_dec_table(nfreqs, high, nb)


class AnsMsb(_LaneCodec):
    """Magnitude-bucketed rANS with exception bytes (reference:
    ans_msb.hpp:41-322), S-lane stream, run on `device`; ANSsmsb-h is
    AnsMsb with its H_approx knob exposed (ans_smsb.hpp).  Its alphabet
    has at most 1280 symbols (MSB_MAX_SIGMA), so it never takes the
    frequency-grouped layout."""

    def __init__(self, h_approx: int = 1, lanes: int | None = None,
                 max_frame: int | None = DEFAULT_MAX_FRAME, *, device):
        self.h_approx = h_approx
        self.lanes = config.validate_lanes(lanes)
        self.max_frame = max_frame
        self.device = torch.device(device)
        self.name = "ANSmsb" if h_approx == 1 else f"ANSsmsb-{h_approx}"

    def _enc_inputs(self, values):
        """(mapped, k, low, nfreqs, nfreqs, raw=False, header=b""), as
        AnsFold._enc_inputs, with the msb map on the device."""
        return _mapped_inputs(self, msb_map_hist(
            _to_device(values, self.device), length=MSB_MAX_SIGMA))

    def _table(self, nfreqs):
        syms = np.arange(len(nfreqs), dtype=np.uint32)
        return tables.build_dec_table(nfreqs, map_np.msb_unmap_high(syms),
                                      map_np.msb_exception_bytes(syms))


def reorder_high(high: np.ndarray, syms: np.ndarray, fidelity: int,
                 most_frequent: np.ndarray | None) -> np.ndarray:
    """The high parts of rfold's symbols: below the fold threshold a
    symbol is a raw value's slot in the reorder header (its value itself
    when no reorder was taken), above it the folded value less the
    threshold the remap added (ans_reorder_fold.hpp:69-385)."""
    thres = fold_threshold(fidelity)
    if most_frequent is not None:
        return np.where(syms < thres,
                        most_frequent[np.minimum(syms, thres - 1)],
                        high - np.uint32(thres)).astype(np.uint32)
    return np.where(syms < thres, syms, high).astype(np.uint32)


def parse_reorder(buf: bytes, fidelity: int, pos: int = 0):
    """(most_frequent u32 array or None, offset past the header) of the
    rfold reorder header at buf[pos:]: a u32 flag, then (flag 1) the
    threshold's count of raw u32 values."""
    do_reorder = int.from_bytes(buf[pos:pos + 4], "little")
    pos += 4
    if do_reorder != 1:
        return None, pos
    thres = fold_threshold(fidelity)
    mf = np.frombuffer(buf, dtype="<u4", count=thres, offset=pos)
    return mf, pos + 4 * thres


class AnsReorderFold(_LaneCodec):
    """Fold + most-frequent-symbol remap (reference:
    ans_reorder_fold.hpp:69-385), S-lane stream, run on `device`.  The
    u32 reorder flag and the raw most_frequent[] table mirror the compat
    header, in front of the prelude."""

    def __init__(self, fidelity: int, h_approx: int = 1,
                 lanes: int | None = None,
                 max_frame: int | None = DEFAULT_MAX_FRAME, *, device):
        if not 1 <= fidelity <= 8:
            raise ValueError(f"fidelity must be in 1..8, got {fidelity}")
        self.fidelity = fidelity
        self.h_approx = h_approx
        self.lanes = config.validate_lanes(lanes)
        self.max_frame = max_frame
        self.device = torch.device(device)
        self.name = f"ANSrfold-{fidelity}"

    def _enc_inputs(self, values):
        """(mapped, k, low, nfreqs, nfreqs, raw=False, header): the host
        reorder pass (reference_model.mappings.craft_reorder), then
        AnsFold's device pass on the remapped values; header is the
        reorder flag and table."""
        values = np.ascontiguousarray(values, dtype=np.uint32)
        if len(values) == 0:
            raise ValueError("cannot encode an empty sequence")
        remapped, header = map_np.craft_reorder(values, self.fidelity)
        return _mapped_inputs(self, fold_map_hist(
            _to_device(remapped, self.device), fidelity=self.fidelity,
            length=fold_max_sigma(self.fidelity)), bytes(header))

    def _dec_table(self, buf: bytes):
        mf, pos = parse_reorder(buf, self.fidelity)
        nfreqs, plen = load_prelude(buf[pos:])
        return self._table(nfreqs, mf), pos + plen

    def _table(self, nfreqs, most_frequent=None):
        """The decode table of a prelude's frequencies under the reorder
        header's most_frequent[] (None: no reorder was taken)."""
        syms = np.arange(len(nfreqs), dtype=np.uint32)
        high, nb = map_np.fold_unmap_high(syms, self.fidelity)
        return tables.build_dec_table(
            nfreqs, reorder_high(high, syms, self.fidelity, most_frequent),
            nb)
