"""Lane-engine ANSfold codecs on PyTorch (counterpart of
ans_tpu/models/ans.py; the other ANS methods are not ported yet).

Pipeline per block (two-pass semi-static):
  1. fold map + exception extraction + histogram  - device (ops.mappings)
  2. adjust_freqs frame search                    - host float64, shared
     with ans_tpu (ans_tpu.reference_model.model)
  3. prelude serialization                        - host, shared
  4. S-lane stream coding                         - device (kernels K1, K2)

The wire format is the lane format of docs/FORMAT.md: compat method
header + prelude, then the fmt-2 lane stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ans_tpu.constants import A_MAX_FRAME_LOG2, fold_max_sigma
from ans_tpu.reference_model import mappings as map_np
from ans_tpu.reference_model.model import (adjust_freqs, load_prelude,
                                           serialize_prelude)

from ..ops import lane_codec, tables
from ..ops.mappings import fold_map_hist
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


def _encode_stream(mapped, nb, low, n: int, nfreqs,
                   lanes: int | None) -> bytes:
    tables.require_ungrouped(nfreqs)
    S = lanes or config.default_lane_count(n)
    T = lane_codec.lane_steps(n, S)
    et = tables.build_enc_table(nfreqs)
    return engine.encode(*_stage_ts(mapped, nb, low, n, S, T), n, et)


def _decode_stream(buf: bytes, off: int, n: int, st: tables.SearchTable,
                   device) -> np.ndarray:
    S, states, payload, _, sec_len = framing.parse(buf, off)
    T = lane_codec.lane_steps(n, S)
    return engine.decode(payload, states, st, n, S=S, T=T, sec_len=sec_len,
                         device=device)


def _encode_via_inputs(codec, values) -> bytes:
    """Model half (codec._enc_inputs) -> prelude -> lane stream."""
    mapped, k, low, nfreqs = codec._enc_inputs(values)
    prelude = serialize_prelude(nfreqs, int(nfreqs.sum()))
    return prelude + _encode_stream(mapped, k, low, int(mapped.shape[0]),
                                    nfreqs, codec.lanes)


def _to_device(values, device) -> torch.Tensor:
    """Host u32 values -> (n,) i32 bit patterns on `device`."""
    values = np.ascontiguousarray(values, dtype=np.uint32)
    if len(values) == 0:
        raise ValueError("cannot encode an empty sequence")
    return torch.from_numpy(values.view(np.int32)).to(device)


class AnsFold:
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
        """(mapped, k, low, nfreqs): the model/mapping half of encode(),
        shared with models.prepare_encoder; the first three are (n,) i32
        device tensors."""
        x = _to_device(values, self.device)
        mapped, k, low, hist = fold_map_hist(
            x, fidelity=self.fidelity, length=fold_max_sigma(self.fidelity))
        freqs = hist.cpu().numpy().astype(np.uint64)
        max_sym = int(np.flatnonzero(freqs)[-1])
        nfreqs = adjust_freqs(freqs, max_sym, True, self.h_approx,
                              lane_frame_cap(self.max_frame))
        return mapped, k, low, nfreqs

    def encode(self, values) -> bytes:
        return _encode_via_inputs(self, values)

    def _search_table(self, nfreqs) -> tables.SearchTable:
        """The pivot-search decode table of a prelude's frequencies;
        raises NotImplementedError for a grouped-layout frame."""
        tables.require_ungrouped(nfreqs)
        syms = np.arange(len(nfreqs), dtype=np.uint32)
        high, nb = map_np.fold_unmap_high(syms, self.fidelity)
        return tables.build_search_table(nfreqs, high, nb)

    def _dec_table(self, buf: bytes):
        """(SearchTable, stream offset) parsed from the wire prelude."""
        nfreqs, plen = load_prelude(buf)
        return self._search_table(nfreqs), plen

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        st, off = self._dec_table(buf)
        return _decode_stream(buf, off, n, st, self.device)
