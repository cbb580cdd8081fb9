"""Device-resident prepared encoders and decoders of the lane engine.

Counterpart of ans_tpu/models/engine.py.  A prepared object stages its
tables and inputs on the device once; each call then runs only the
kernels.  This is both the serving pattern (compressed blocks live in
device memory next to their consumer) and the honest device benchmark.

The engine follows the slot layout, a format property the prelude
decides: frames with more than 2^13 live symbols use the frequency-
grouped layout and run the grouped kernels (encode K6, decode K5), the
others the value-indexed scan (K1) and the pivot search (K3); placement
(K2) serves both.  ans_tpu's direct engine (K4) and its TPU cost model
(`choose_decode_engine`), which may prefer it, are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lane_codec, tables
from ..ops.decode import decode_grouped, decode_search
from ..ops.encode import encode_scan, encode_scan_grouped
from ..ops.place import place
from . import framing


class PreparedDecoder:
    """All decode inputs staged on `device`; call to run the decoder.
    `engine` is "grouped" (K5) for a GroupedTable, "search" (K3) for a
    SearchTable."""

    def __init__(self, payload: np.ndarray, states: np.ndarray, table,
                 n: int, *, S: int, T: int, sec_len, device):
        if int(np.sum(sec_len)) != len(payload):
            raise ValueError("corrupt lane header: section lengths do not "
                             "sum to the stream length")
        self.n, self.S, self.T = n, S, T
        self.device = torch.device(device)
        grouped = isinstance(table, tables.GroupedTable)
        self.engine = "grouped" if grouped else "search"
        self._kernel = decode_grouped if grouped else decode_search
        self.table = tables.to_device(table, self.device)
        self.stream = torch.from_numpy(
            np.array(payload, dtype=np.uint8)).to(self.device)
        self.states = torch.from_numpy(
            np.asarray(states, dtype=np.uint32).view(np.int32).copy()).to(
            self.device)

    def __call__(self) -> torch.Tensor:
        """Run the decoder; returns the (T, S) i32 device tensor."""
        return self._kernel(self.stream, self.states, self.table, self.n,
                            self.T)

    def to_host(self, out: torch.Tensor) -> np.ndarray:
        return out.reshape(-1)[: self.n].cpu().numpy().view(np.uint32)


def decode(payload: np.ndarray, states: np.ndarray, table, n: int, *,
           S: int, T: int, sec_len, device) -> np.ndarray:
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


def _scan(syms: torch.Tensor, n: int, table):
    """The encode scan a device table calls for: K6 under the grouped
    layout (tables.GroupedEncDevice), K1 otherwise (tables.EncDevice)."""
    if isinstance(table, tables.GroupedEncDevice):
        return encode_scan_grouped(syms, n, table)
    return encode_scan(syms, n, table)


def encode(mapped_ts: torch.Tensor, nb_ts: torch.Tensor,
           excw_ts: torch.Tensor, n: int, table) -> bytes:
    """One-shot: scan, plan the sections, place, and frame the stream.

    mapped_ts/nb_ts/excw_ts: (T, S) i32 tensors (symbols or ranks,
    exception-byte counts, the values' three low bytes) and the scan's
    device table, all on one device."""
    packed, states = _scan(mapped_ts, n, table)
    round_base, total, t_sec, sec_len = _section_plan(packed, nb_ts, n)
    stream = place(packed, nb_ts, excw_ts, n, round_base, total)
    return framing.pack(states.cpu().numpy().view(np.uint32),
                        stream.cpu().numpy(), t_sec, sec_len)


class PreparedEncoder:
    """Device-resident encode: inputs and the scan's device table staged
    as for `encode`, and the section plan fixed by one priming scan; each
    call then runs the scan kernel, the round totals and the placement
    kernel."""

    def __init__(self, mapped_ts: torch.Tensor, nb_ts: torch.Tensor,
                 excw_ts: torch.Tensor, n: int, table):
        self.n = n
        self.T, self.S = mapped_ts.shape
        self.mapped_ts, self.nb_ts, self.excw_ts = mapped_ts, nb_ts, excw_ts
        self.table = table
        packed, _ = _scan(mapped_ts, n, table)
        _, self.total, self.t_sec, self.sec_len = _section_plan(
            packed, nb_ts, n)

    def __call__(self):
        """Returns (stream (total,) u8, states (S,) i32), on the device."""
        packed, states = _scan(self.mapped_ts, self.n, self.table)
        round_base, _ = lane_codec.encode_totals(packed, self.nb_ts, self.n)
        stream = place(packed, self.nb_ts, self.excw_ts, self.n, round_base,
                       self.total)
        return stream, states

    def to_bytes(self, stream: torch.Tensor, states: torch.Tensor) -> bytes:
        return framing.pack(states.cpu().numpy().view(np.uint32),
                            stream.cpu().numpy(), self.t_sec, self.sec_len)
