"""Device-resident prepared encoders and decoders of the lane engine.

Counterpart of ans_tpu/models/engine.py.  A prepared object stages its
tables and inputs on the device once; each call then runs only the
kernels.  This is both the serving pattern (compressed blocks live in
device memory next to their consumer) and the honest device benchmark.

The encode engine follows the slot layout, a format property the prelude
decides: frames with more than 2^13 live symbols use the frequency-
grouped layout and run the grouped scan (K6), the others the
value-indexed scan (K1); placement (K2) serves both.  Decoding has three
engines.  "search" (K3) and "grouped" (K5) each read their own layout;
"direct" (K4) reads a per-slot table, under either layout, when that
table fits the shared memory of one block.  The engine is not visible on
the wire; `choose_decode_engine` picks it from the table.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import tables
from ..ops.decode import decode_direct, decode_grouped, decode_search
from ..ops.encode import encode_scan, encode_scan_grouped
from ..ops.place import place
from . import framing

ENGINES = ("search", "grouped", "direct")


def eligible_engines(table) -> tuple:
    """The decode engines that can read `table` (a tables.SearchTable or
    tables.GroupedTable): the layout's own, and "direct" when the per-slot
    table fits shared memory."""
    own = "grouped" if isinstance(table, tables.GroupedTable) else "search"
    return (own, "direct") if tables.direct_fits(table) else (own,)


def choose_decode_engine(table, S: int) -> str:
    """The decode engine for `table` at S lanes: "direct" wherever it is
    eligible, else the layout's own engine.  A pure function of the
    table: eligibility is capacity (tables.direct_fits), and no crossover
    was found inside it.  On an NVIDIA H100 80GB HBM3 at 700 W
    (ans_tpu_torch/bench_crossover.py; PERF.md has the table) K4 took
    0.20-0.81 of K3's time on every value-order frame that fits (sigma 16
    to 8192, M 2^8 to 2^16; 0.44 on ANSfold-2's main path, 0.49 on
    AnsByte) at S = 4096, and 0.55-0.64 at S = 32: two dependent
    shared-memory loads against the search's chain of probes.  A frame
    whose tables leave K4 no room for the stream's ring
    (ops.decode.choose_instance) still decodes faster on K4's global-load
    instance than on K3 with its ring.  Against K5 the margin is gone
    since K5 took the same step and a bucket search: K4 took 0.91 of
    K5's time on the grouped frame whose ring fits beside K4's tables
    (0.84 at S = 32) and 1.10-1.12 on the two where it does not; the rule
    was derived before that and has not been moved."""
    del S  # the order of the engines held at both lane counts measured
    engines = eligible_engines(table)
    return "direct" if "direct" in engines else engines[0]


class PreparedDecoder:
    """All decode inputs staged on `device`; call to run the decoder.
    `engine` is "search" (K3), "grouped" (K5) or "direct" (K4); None
    leaves the choice to choose_decode_engine.  An engine the table is
    not eligible for raises ValueError."""

    def __init__(self, payload: np.ndarray, states: np.ndarray, table,
                 n: int, *, S: int, T: int, sec_len, device,
                 engine: str | None = None):
        if int(np.sum(sec_len)) != len(payload):
            raise ValueError("corrupt lane header: section lengths do not "
                             "sum to the stream length")
        self.n, self.S, self.T = n, S, T
        self.device = torch.device(device)
        if engine is None:
            engine = choose_decode_engine(table, S)
        elif engine not in eligible_engines(table):
            raise ValueError(
                f"decode engine {engine!r} is not eligible for this frame "
                f"(eligible: {eligible_engines(table)}; \"direct\" needs "
                f"{tables.direct_table_bytes(table)} bytes of tables in "
                f"{tables.DIRECT_TABLE_BYTES})")
        self.engine = engine
        if engine == "direct":
            table = tables.materialize_slots(table)
        self._kernel = {"search": decode_search, "grouped": decode_grouped,
                        "direct": decode_direct}[engine]
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
           S: int, T: int, sec_len, device,
           engine: str | None = None) -> np.ndarray:
    """One-shot: stage, run, and return the host u32 array."""
    prep = PreparedDecoder(payload, states, table, n, S=S, T=T,
                           sec_len=sec_len, device=device, engine=engine)
    return prep.to_host(prep())


def _section_plan(step_base: torch.Tensor, total: int, T: int):
    """(t_sec, sec_len): the section cut (wire format), chosen on the host
    from the placement's T step offsets."""
    return framing.choose_sections(step_base.cpu().numpy(), total, T)


def _scan(syms: torch.Tensor, n: int, table):
    """The encode scan a device table calls for: K6 under the grouped
    layout (tables.GroupedEncDevice), K1 otherwise (tables.EncDevice)."""
    if isinstance(table, tables.GroupedEncDevice):
        return encode_scan_grouped(syms, n, table)
    return encode_scan(syms, n, table)


def encode(mapped_ts: torch.Tensor, nb_ts: torch.Tensor,
           excw_ts: torch.Tensor, n: int, table) -> bytes:
    """One-shot: scan, place, plan the sections, and frame the stream.

    mapped_ts/nb_ts/excw_ts: (T, S) i32 tensors (symbols or ranks,
    exception-byte counts, the values' three low bytes) and the scan's
    device table, all on one device."""
    packed, states = _scan(mapped_ts, n, table)
    stream, step_base, total = place(packed, nb_ts, excw_ts, n)
    t_sec, sec_len = _section_plan(step_base, total, packed.shape[0])
    return framing.pack(states.cpu().numpy().view(np.uint32),
                        stream.cpu().numpy(), t_sec, sec_len)


class PreparedEncoder:
    """Device-resident encode: inputs and the scan's device table staged
    as for `encode`, and the section plan fixed by one priming scan and
    placement; each call then runs the scan kernel and the placement
    kernel, which checks the stream's length against the plan."""

    def __init__(self, mapped_ts: torch.Tensor, nb_ts: torch.Tensor,
                 excw_ts: torch.Tensor, n: int, table):
        self.n = n
        self.T, self.S = mapped_ts.shape
        self.mapped_ts, self.nb_ts, self.excw_ts = mapped_ts, nb_ts, excw_ts
        self.table = table
        packed, _ = _scan(mapped_ts, n, table)
        _, step_base, self.total = place(packed, nb_ts, excw_ts, n)
        self.t_sec, self.sec_len = _section_plan(step_base, self.total,
                                                 self.T)

    def __call__(self):
        """Returns (stream (total,) u8, states (S,) i32), on the device."""
        packed, states = _scan(self.mapped_ts, self.n, self.table)
        stream, _, _ = place(packed, self.nb_ts, self.excw_ts, self.n,
                             self.total)
        return stream, states

    def to_bytes(self, stream: torch.Tensor, states: torch.Tensor) -> bytes:
        return framing.pack(states.cpu().numpy().view(np.uint32),
                            stream.cpu().numpy(), self.t_sec, self.sec_len)
