"""Device-resident prepared encoders and decoders of the lane engine.

Counterpart of ans_tpu/models/engine.py.  A prepared object stages its
tables and inputs on the device once; each call then runs only the
kernels.  This is both the serving pattern (compressed blocks live in
device memory next to their consumer) and the honest device benchmark.

Decode runs the pivot-search engine only (kernel K3).  ans_tpu's engine
cost model (`choose_decode_engine`) weighs TPU shuffle costs and is not
ported; grouped-layout frames, which the search engine cannot take,
raise NotImplementedError (naming the kernels that will take them) when
their table is built (models.ans.AnsFold._search_table).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lane_codec, tables
from ..ops.decode import decode_search
from ..ops.encode import encode_scan
from ..ops.place import place
from . import framing


class PreparedDecoder:
    """All decode inputs staged on `device`; call to run the decoder."""

    def __init__(self, payload: np.ndarray, states: np.ndarray,
                 table: tables.SearchTable, n: int, *, S: int, T: int,
                 sec_len, device):
        if int(np.sum(sec_len)) != len(payload):
            raise ValueError("corrupt lane header: section lengths do not "
                             "sum to the stream length")
        self.n, self.S, self.T = n, S, T
        self.device = torch.device(device)
        self.table = tables.to_device(table, self.device)
        self.stream = torch.from_numpy(
            np.array(payload, dtype=np.uint8)).to(self.device)
        self.states = torch.from_numpy(
            np.asarray(states, dtype=np.uint32).view(np.int32).copy()).to(
            self.device)

    def __call__(self) -> torch.Tensor:
        """Run the decoder; returns the (T, S) i32 device tensor."""
        return decode_search(self.stream, self.states, self.table, self.n,
                             self.T)

    def to_host(self, out: torch.Tensor) -> np.ndarray:
        return out.reshape(-1)[: self.n].cpu().numpy().view(np.uint32)


def decode(payload: np.ndarray, states: np.ndarray,
           table: tables.SearchTable, n: int, *, S: int, T: int, sec_len,
           device) -> np.ndarray:
    """One-shot: stage, run, and return the host u32 array."""
    prep = PreparedDecoder(payload, states, table, n, S=S, T=T,
                           sec_len=sec_len, device=device)
    return prep.to_host(prep())


def _section_plan(packed: torch.Tensor, nb_ts: torch.Tensor, n: int):
    """(round_base, total, t_sec, sec_len) of a scan's packed words; the
    section cut (wire format) is chosen on the host from the T step
    offsets."""
    round_base, total = lane_codec.encode_totals(packed, nb_ts, n)
    total = int(total)
    t_sec, sec_len = framing.choose_sections(
        round_base[::lane_codec.NROUNDS].cpu().numpy(), total,
        packed.shape[0])
    return round_base, total, t_sec, sec_len


def encode(mapped_ts: torch.Tensor, nb_ts: torch.Tensor,
           excw_ts: torch.Tensor, n: int, et: tables.EncTable) -> bytes:
    """One-shot: scan, plan the sections, place, and frame the stream.

    mapped_ts/nb_ts/excw_ts: (T, S) i32 tensors (symbols, exception-byte
    counts, the values' three low bytes), all on one device."""
    table = tables.to_device(et, mapped_ts.device)
    packed, states = encode_scan(mapped_ts, n, table)
    round_base, total, t_sec, sec_len = _section_plan(packed, nb_ts, n)
    stream = place(packed, nb_ts, excw_ts, n, round_base, total)
    return framing.pack(states.cpu().numpy().view(np.uint32),
                        stream.cpu().numpy(), t_sec, sec_len)


class PreparedEncoder:
    """Device-resident encode: inputs staged (T, S) as for `encode`,
    tables uploaded, and the section plan fixed by one priming scan; each
    call then runs the scan kernel, the round totals and the placement
    kernel."""

    def __init__(self, mapped_ts: torch.Tensor, nb_ts: torch.Tensor,
                 excw_ts: torch.Tensor, n: int, et: tables.EncTable):
        self.n = n
        self.T, self.S = mapped_ts.shape
        self.mapped_ts, self.nb_ts, self.excw_ts = mapped_ts, nb_ts, excw_ts
        self.table = tables.to_device(et, mapped_ts.device)
        packed, _ = encode_scan(mapped_ts, n, self.table)
        _, self.total, self.t_sec, self.sec_len = _section_plan(
            packed, nb_ts, n)

    def __call__(self):
        """Returns (stream (total,) u8, states (S,) i32), on the device."""
        packed, states = encode_scan(self.mapped_ts, self.n, self.table)
        round_base, _ = lane_codec.encode_totals(packed, self.nb_ts, self.n)
        stream = place(packed, self.nb_ts, self.excw_ts, self.n, round_base,
                       self.total)
        return stream, states

    def to_bytes(self, stream: torch.Tensor, states: torch.Tensor) -> bytes:
        return framing.pack(states.cpu().numpy().view(np.uint32),
                            stream.cpu().numpy(), self.t_sec, self.sec_len)
