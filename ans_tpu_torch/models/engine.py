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

Every kernel takes a batch of D streams (`PreparedBatchEncoder`,
`PreparedBatchDecoder`) that share one model (the sections of a blocked
container, parallel/block_runtime.py) or have one each (the blocks of a
pseudo-adaptive container, models/pseudo_adaptive.py; ops/model_batch.py
lays their tables out): one scan launch, one placement launch and one
decode launch serve the whole batch.  The one-stream objects
(`PreparedEncoder`, `PreparedDecoder`, `encode`, `decode`) are the batch
of one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import model_batch, tables
from ..ops.decode import (decode_direct_batch, decode_grouped_batch,
                          decode_search_batch)
from ..ops.encode import encode_scan_batch, encode_scan_grouped_batch
from ..ops.lane_codec import batch_of_one
from ..ops.place import place_batch
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


def dec_device_table(table, engine: str, device):
    """The device table `engine`'s kernel reads for a decode table."""
    if engine == "direct":
        table = tables.materialize_slots(table)
    return tables.to_device(table, device)


class PreparedBatchDecoder:
    """D streams staged on `device`, each of T steps of S lanes: their
    payloads one after the other in one buffer, their states (D, S) and
    lengths n_sec (D,); each call is one launch of the engine's kernel for
    the whole batch.  `table` is the decode table the streams share, or the
    ModelBatch of their device tables for `engine` (dec_device_table; one
    a stream, ops/model_batch.py).  `engine` is "search" (K3), "grouped"
    (K5) or "direct" (K4); None leaves the choice to choose_decode_engine.
    An engine the table is not eligible for raises ValueError."""

    def __init__(self, payloads, states: np.ndarray, table, n_sec, *, S: int,
                 T: int, device, engine: str | None = None):
        self.device = torch.device(device)
        if isinstance(table, model_batch.ModelBatch):
            if engine is None:
                raise ValueError("a ModelBatch of device tables is read by "
                                 "the engine it was made for: pass it")
            self.table = table
        else:
            if engine is None:
                engine = choose_decode_engine(table, S)
            elif engine not in eligible_engines(table):
                raise ValueError(
                    f"decode engine {engine!r} is not eligible for this "
                    f"frame (eligible: {eligible_engines(table)}; \"direct\" "
                    f"needs {tables.direct_table_bytes(table)} bytes of "
                    f"tables in {tables.DIRECT_TABLE_BYTES})")
            self.table = dec_device_table(table, engine, self.device)
        self.engine = engine
        self._kernel = {"search": decode_search_batch,
                        "grouped": decode_grouped_batch,
                        "direct": decode_direct_batch}[engine]
        self.n_sec = np.asarray(n_sec, dtype=np.int64)
        self.S, self.T = S, T
        lens = [len(p) for p in payloads]
        self.stream = torch.from_numpy(np.concatenate(
            [np.asarray(p, dtype=np.uint8) for p in payloads])).to(
            self.device)
        off = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
        self.stream_off = torch.from_numpy(off).to(self.device)
        self.states = torch.from_numpy(
            np.asarray(states, dtype=np.uint32).view(np.int32).copy()).to(
            self.device)
        self.n = torch.from_numpy(self.n_sec).to(self.device)

    def __call__(self) -> torch.Tensor:
        """Run the decoder; returns the (D, T, S) i32 device tensor."""
        return self._kernel(self.stream, self.stream_off, self.states,
                            self.n, self.table, self.T)

    def to_host(self, out: torch.Tensor) -> np.ndarray:
        """The D streams' values, one after the other, as host u32."""
        flat = out.reshape(len(self.n_sec), -1)
        return torch.cat([flat[d, :n] for d, n in enumerate(
            self.n_sec.tolist())]).cpu().numpy().view(np.uint32)


class PreparedDecoder(PreparedBatchDecoder):
    """One stream's decode inputs staged on `device`: PreparedBatchDecoder
    on a batch of one (engine as there); call to run the decoder."""

    def __init__(self, payload: np.ndarray, states: np.ndarray, table,
                 n: int, *, S: int, T: int, sec_len, device,
                 engine: str | None = None):
        if int(np.sum(sec_len)) != len(payload):
            raise ValueError("corrupt lane header: section lengths do not "
                             "sum to the stream length")
        super().__init__([payload], np.asarray(states)[None], table, [n],
                         S=S, T=T, device=device, engine=engine)

    def __call__(self) -> torch.Tensor:
        """Run the decoder; returns the (T, S) i32 device tensor."""
        return super().__call__()[0]

    def to_host(self, out: torch.Tensor) -> np.ndarray:
        return super().to_host(out[None])


def decode(payload: np.ndarray, states: np.ndarray, table, n: int, *,
           S: int, T: int, sec_len, device,
           engine: str | None = None) -> np.ndarray:
    """One-shot: stage, run, and return the host u32 array."""
    prep = PreparedDecoder(payload, states, table, n, S=S, T=T,
                           sec_len=sec_len, device=device, engine=engine)
    return prep.to_host(prep())


def _section_plan(step_base: np.ndarray, total: int, T: int):
    """(t_sec, sec_len): the section cut (wire format), chosen on the host
    from the placement's T step offsets."""
    return framing.choose_sections(step_base, total, T)


def _scan(syms: torch.Tensor, n: torch.Tensor, table):
    """The encode scans of a (D, T, S) batch a device table (or a
    ModelBatch of them) calls for: K6 under the grouped layout
    (tables.GroupedEncDevice), K1 otherwise (tables.EncDevice)."""
    kind = (table.kind if isinstance(table, model_batch.ModelBatch)
            else type(table))
    if kind is tables.GroupedEncDevice:
        return encode_scan_grouped_batch(syms, n, table)
    return encode_scan_batch(syms, n, table)


def encode_streams(mapped: torch.Tensor, nb: torch.Tensor,
                   excw: torch.Tensor, n: torch.Tensor, table):
    """One scan launch and one placement launch for D streams of one
    model: (D, T, S) staged inputs and the (D,) i64 lengths n, all on one
    device.  Returns (stream u8: the D streams one after the other,
    offsets (D, T + 1) i64: each step's offset in it, then the stream's
    end, ends (D,) host i64, states (D, S) i32)."""
    packed, states = _scan(mapped, n, table)
    stream, offsets, ends = place_batch(packed, nb, excw, n)
    return stream, offsets, ends, states


class PreparedBatchEncoder:
    """Device-resident encode of D streams: the (D, T, S) i32 staged inputs
    (symbols or ranks, exception-byte counts, the values' three low bytes),
    the lengths n_sec (D,) and the scan's device table the streams share or
    a ModelBatch of one a stream, all on one device.  One priming scan and
    placement fix each stream's step offsets (`offsets`, (D, T + 1) host
    i64 positions in the batch's stream) and ends; each call then runs one
    scan launch and one placement launch for the batch, the placement
    checking the ends."""

    def __init__(self, mapped: torch.Tensor, nb: torch.Tensor,
                 excw: torch.Tensor, n_sec, table):
        self.n_sec = np.asarray(n_sec, dtype=np.int64)
        self.D, self.T, self.S = mapped.shape
        self.mapped, self.nb, self.excw = mapped, nb, excw
        self.table = table
        self.lengths = torch.from_numpy(self.n_sec).to(mapped.device)
        _, offsets, self.ends, _ = encode_streams(mapped, nb, excw,
                                                  self.lengths, table)
        self.offsets = offsets.cpu().numpy()

    def __call__(self):
        """Returns (stream u8: the D streams one after the other, states
        (D, S) i32), on the device."""
        packed, states = _scan(self.mapped, self.lengths, self.table)
        stream, _, _ = place_batch(packed, self.nb, self.excw, self.lengths,
                                   self.ends)
        return stream, states


class PreparedEncoder(PreparedBatchEncoder):
    """Device-resident encode of one stream: PreparedBatchEncoder on a
    batch of one, with the section plan fixed by the priming run."""

    def __init__(self, mapped_ts: torch.Tensor, nb_ts: torch.Tensor,
                 excw_ts: torch.Tensor, n: int, table):
        super().__init__(mapped_ts[None], nb_ts[None], excw_ts[None], [n],
                         table)
        self.n = n
        self.total = int(self.ends[0])
        self.t_sec, self.sec_len = _section_plan(self.offsets[0, :-1],
                                                 self.total, self.T)

    def __call__(self):
        """Returns (stream (total,) u8, states (S,) i32), on the device."""
        stream, states = super().__call__()
        return stream, states[0]

    def to_bytes(self, stream: torch.Tensor, states: torch.Tensor) -> bytes:
        return framing.pack(states.cpu().numpy().view(np.uint32),
                            stream.cpu().numpy(), self.t_sec, self.sec_len)


def encode(mapped_ts: torch.Tensor, nb_ts: torch.Tensor,
           excw_ts: torch.Tensor, n: int, table) -> bytes:
    """One-shot: scan, place, plan the sections, and frame the stream.

    mapped_ts/nb_ts/excw_ts: (T, S) i32 tensors (symbols or ranks,
    exception-byte counts, the values' three low bytes) and the scan's
    device table, all on one device: the batch of one."""
    stream, offsets, ends, states = encode_streams(
        mapped_ts[None], nb_ts[None], excw_ts[None],
        batch_of_one(mapped_ts.device, n), table)
    T = mapped_ts.shape[0]
    t_sec, sec_len = _section_plan(offsets[0, :T].cpu().numpy(),
                                   int(ends[0]), T)
    return framing.pack(states[0].cpu().numpy().view(np.uint32),
                        stream.cpu().numpy(), t_sec, sec_len)
