"""Lane-engine ANS codecs on PyTorch (counterpart of ans_tpu/models/ans.py):
AnsFold (ANSfold-1..8) and AnsInt (ANS, and ANSsint-h: the reference's
ans_sint.hpp is AnsInt with its H_approx knob exposed).

Pipeline per block (two-pass semi-static):
  1. mapping + exception extraction + histogram  - device fold map
     (ops.mappings) or host tail escape (ops.escape)
  2. adjust_freqs frame search                    - host float64
     (reference_model.model, the port's copy of ans_tpu's)
  3. prelude serialization                        - host, likewise
  4. S-lane stream coding                         - device: the encode scan
     (K1, or K6 under the frequency-grouped layout) and placement (K2)

The wire format is the lane format of docs/FORMAT.md: compat method
header + prelude, then the fmt-2 lane stream.  Frames with more than 2^13
live symbols use the frequency-grouped slot layout (ops/grouped.py); the
identity coders fold huge alphabets with the tail escape first.  Both
choices are pure functions of the prelude, so decoders re-derive them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import A_MAX_FRAME_LOG2, fold_max_sigma
from ..ops import escape, grouped, lane_codec, tables
from ..ops.mappings import fold_map_hist
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


def _stage(mapped, nb, low, n: int, ffreqs, raw: bool, S: int):
    """The encode scan's table and the (T, S) staged inputs.

    The frame's frequencies select the slot layout (a format decision
    both coder sides derive identically).  Value-cumulative: K1's
    per-symbol table.  Frequency-grouped: K6's group tables; `raw` coders
    (mapped holds the values themselves) gather each value's rank on the
    device, the others leave the symbol -> rank map to the kernel."""
    T = lane_codec.lane_steps(n, S)
    device = mapped.device
    if not grouped.use_grouped_layout(ffreqs):
        table = tables.to_device(tables.build_enc_table(ffreqs), device)
    else:
        layout = grouped.build_group_layout(ffreqs)
        table = tables.grouped_enc_to_device(layout, device,
                                             rank_of=not raw)
        if raw:
            rank_of = torch.from_numpy(layout.rank_of.view(np.int32)).to(
                device)
            mapped = rank_of[mapped.to(torch.int64) & 0xFFFFFFFF]
    return table, _stage_ts(mapped, nb, low, n, S, T)


def _to_device(values, device) -> torch.Tensor:
    """Host u32 values -> (n,) i32 bit patterns on `device`."""
    values = np.ascontiguousarray(values, dtype=np.uint32)
    if len(values) == 0:
        raise ValueError("cannot encode an empty sequence")
    return torch.from_numpy(values.view(np.int32)).to(device)


class _LaneCodec:
    """What the lane codecs share: a subclass gives `_enc_inputs` (the
    model half of encode: mapped symbols, exception counts and low bytes
    on the device, the prelude and frame frequencies, and whether the
    symbols are raw values) and `_table` (the decode table of a prelude's
    frequencies); one with another prelude than the ANS family's
    overrides `_prelude` and `_dec_table`."""

    def _prelude(self, pfreqs) -> bytes:
        """The wire prelude of the model's frequencies."""
        return serialize_prelude(pfreqs, int(pfreqs.sum()))

    def encode(self, values) -> bytes:
        """Model half -> prelude -> lane stream.  The prelude serialises
        the true per-symbol frequencies (pfreqs); the frame runs over
        ffreqs, which differ only under the tail escape."""
        mapped, k, low, pfreqs, ffreqs, raw = self._enc_inputs(values)
        n = int(mapped.shape[0])
        table, staged = _stage(mapped, k, low, n, ffreqs, raw,
                               self.lanes or config.default_lane_count(n))
        return self._prelude(pfreqs) + engine.encode(*staged, n, table)

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
        """(mapped, k, low, prelude_freqs, frame_freqs, raw): the model
        half of encode(), shared with models.prepare_encoder.  The first
        three are (n,) i32 device tensors.  Huge live alphabets take the
        tail escape (the frame then runs over the folded alphabet, the
        prelude keeps the true vector); otherwise mapped holds the raw
        values (raw=True)."""
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
                    plan.frame_freqs, False)
        zero = torch.zeros_like(x)
        return x, zero, zero, nfreqs, nfreqs, True

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
        """(mapped, k, low, nfreqs, nfreqs, raw=False): the model half of
        encode(), as AnsInt._enc_inputs; the mapping runs on the device."""
        x = _to_device(values, self.device)
        mapped, k, low, hist = fold_map_hist(
            x, fidelity=self.fidelity, length=fold_max_sigma(self.fidelity))
        freqs = hist.cpu().numpy().astype(np.uint64)
        max_sym = int(np.flatnonzero(freqs)[-1])
        nfreqs = adjust_freqs(freqs, max_sym, True, self.h_approx,
                              lane_frame_cap(self.max_frame))
        return mapped, k, low, nfreqs, nfreqs, False

    def _table(self, nfreqs):
        """The decode table of a prelude's frequencies (grouped past 2^13
        live symbols, pivot search below)."""
        syms = np.arange(len(nfreqs), dtype=np.uint32)
        high, nb = map_np.fold_unmap_high(syms, self.fidelity)
        return tables.build_dec_table(nfreqs, high, nb)
