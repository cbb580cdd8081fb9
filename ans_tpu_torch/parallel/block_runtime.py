"""The blocked container (ATFB v2) on one device (counterpart of
ans_tpu/parallel/block_runtime.py).

The input is split into D contiguous sections of B = ceil(n / D) values
(the last ones shorter, or empty), one model is built from the histogram
of all of them, and each section is coded as its own fmt-2 lane stream
under that model.  ans_tpu runs the sections one per device of a mesh; on
one GPU they are one batch: one device pass maps every section and sums
the histogram, one scan launch and one placement launch encode them all,
and one decode launch decodes them all, one block a section.  `make_mesh`
is not ported: `sections=D` takes the mesh's place (several GPUs are
ROADMAP queue 1 item 10).

Methods: ANS / ANSmsb / ANSfold-f / ANSrfold-f / ANSsint-h / ANSsmsb-h.

Wire format (the ATFB writer of ans_tpu's code; docs/FORMAT.md section 3
still shows an older header): struct "<IBBBBII" magic, version 2, kind,
fidelity, h_approx, n, D; rfold's reorder header; u32 prelude length and
the prelude; then for each section a u32 length and its fmt-2 lane blob.
The section cut of each stream (t_sec) is the one ans_tpu's production
engine writes: one t_sec for all sections (framing.choose_sections_joint)
where that engine runs (production_engine_ok), each section's own
(framing.choose_sections) where it falls back to its portable engine.
Both cuts agree while every section stays under the 3 MB cap.  The
decoder reads either: its streams are read with one cursor each, whatever
their cut.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..constants import MSB_MAX_SIGMA, fold_max_sigma
from ..models import ans as lane, config, engine, framing
from ..ops import escape, grouped, lane_codec
from ..ops.mappings import fold_map_hist, msb_map_hist
from ..reference_model import mappings as map_np
from ..reference_model.model import (adjust_freqs, load_prelude,
                                     serialize_prelude)

MAGIC = 0x41544642  # "BFTA" little-endian -> "ATFB"
VERSION = 2

KINDS = {"int": 0, "msb": 1, "fold": 2, "rfold": 3}
_KIND_NAMES = {v: k for k, v in KINDS.items()}

_HEADER = struct.Struct("<IBBBBII")


def describe_container(blob: bytes):
    """(method, n, D) from an ATFB header: the inverse of _parse_method
    over the stored kind, fidelity and h_approx, so that a caller can
    build the matching BlockCodec without knowing more."""
    magic, _ver, kind_id, fid, h_app, n, D = _HEADER.unpack_from(blob, 0)
    if magic != MAGIC:
        raise ValueError("not an ATFB container")
    kind = _KIND_NAMES[kind_id]
    if kind == "int":
        method = "ANS" if h_app == 1 else f"ANSsint-{h_app}"
    elif kind == "msb":
        method = "ANSmsb" if h_app == 1 else f"ANSsmsb-{h_app}"
    else:
        method = f"ANS{kind}-{fid}"
    return method, int(n), int(D)


def _parse_method(method: str):
    """-> (kind, fidelity, h_approx)."""
    if method == "ANS":
        return "int", 0, 1
    if method == "ANSmsb":
        return "msb", 0, 1
    for prefix, kind in (("ANSfold-", "fold"), ("ANSrfold-", "rfold"),
                         ("ANSsint-", "int"), ("ANSsmsb-", "msb")):
        if method.startswith(prefix):
            v = int(method[len(prefix):])
            if kind in ("fold", "rfold"):
                return kind, v, 1
            return kind, 0, v
    raise ValueError(f"blocked runtime supports ANS/ANSmsb/ANSfold-f/"
                     f"ANSrfold-f/ANSsint-H/ANSsmsb-H, not {method!r}")


def production_engine_ok(frame_freqs, S: int, grouped_layout: bool) -> bool:
    """Whether ans_tpu's BlockCodec encodes a frame on its production
    (Pallas) engine, which cuts all sections with one t_sec, rather than
    on its portable engine, which cuts each on its own: a copy of
    `_encode_pallas_ok` (block_runtime.py:434-442), held equal to it by
    tests/test_torch_blocked.py, because the cut is wire format."""
    nf = np.asarray(frame_freqs, dtype=np.uint64)
    M = int(nf.sum())
    # S/128 power-of-two: placement kernel row->(step,row) math
    return (S >= 128 and S % 128 == 0
            and (S // 128) & (S // 128 - 1) == 0
            and 2 <= M <= (1 << 22)
            # grouped layout: rank-space prefetch, no sigma cap
            and (grouped_layout or len(nf) <= (1 << 13))
            and int(nf.max()) < M)


def section_lengths(n: int, D: int):
    """(B, n_sec): the section size ceil(n / D) and the (D,) i64 values
    of each section (the last ones shorter, or empty)."""
    B = -(-n // D)
    return B, np.clip(n - B * np.arange(D), 0, B).astype(np.int64)


class BlockCodec:
    """Shared-model, block-parallel encode and decode of `method` in
    `sections` sections on `device`, writing `lanes` lanes a section
    (None: the default lane count of a section)."""

    def __init__(self, method: str = "ANSfold-2", sections: int = 1,
                 lanes: int | None = None, h_approx: int | None = None, *,
                 device):
        self.kind, self.fidelity, h_m = _parse_method(method)
        self.h_approx = h_approx if h_approx is not None else h_m
        self.method = method
        if sections < 1:
            raise ValueError(f"sections must be >= 1, got {sections}")
        self.sections = sections
        self.lanes = config.validate_lanes(lanes)
        self.device = torch.device(device)
        # the unblocked codec of the kind: its decode table is the
        # container's
        self._codec = {
            "int": lambda: lane.AnsInt(self.h_approx, device=device),
            "msb": lambda: lane.AnsMsb(self.h_approx, device=device),
            "fold": lambda: lane.AnsFold(self.fidelity, device=device),
            "rfold": lambda: lane.AnsReorderFold(self.fidelity,
                                                 device=device),
        }[self.kind]()

    # -- shared-model front end (one device pass over all sections) ------

    @property
    def _sigma_cap(self):
        if self.kind == "msb":
            return MSB_MAX_SIGMA
        if self.kind in ("fold", "rfold"):
            return fold_max_sigma(self.fidelity)
        return None

    def _padding_symbol(self) -> int:
        """Mapped id the zero padding contributes to the histogram (the
        values are padded to D*B with zeros before the device pass)."""
        if self.kind == "msb":
            return int(map_np.msb_map(np.zeros(1, np.uint32))[0])
        if self.kind in ("fold", "rfold"):
            return int(map_np.fold_map(np.zeros(1, np.uint32),
                                       self.fidelity)[0])
        return 0

    def _map_hist(self, x: torch.Tensor, sigma_cap: int):
        """(D*B,) i32 values -> mapped, k, low (D*B,) i32 and the
        histogram of all sections (sigma_cap,) i64, on the device."""
        if self.kind == "msb":
            return msb_map_hist(x, length=sigma_cap)
        if self.kind in ("fold", "rfold"):
            return fold_map_hist(x, fidelity=self.fidelity, length=sigma_cap)
        v = x.to(torch.int64) & 0xFFFFFFFF
        zero = torch.zeros_like(x)
        return x, zero, zero, torch.bincount(v, minlength=sigma_cap)

    # -- encode -----------------------------------------------------------

    def _front(self, values, hist_override=None, reorder_header=None):
        """The model half of encode: (the container's bytes up to the
        sections, the (D, T, S) staged inputs, the sections' lengths (D,)
        i64 on the device, the scan's table, whether the sections share
        one cut)."""
        values = np.ascontiguousarray(values, dtype=np.uint32)
        n = len(values)
        if n == 0:
            raise ValueError("cannot encode an empty sequence")
        header_extra = b""
        if self.kind == "rfold":
            if reorder_header is not None:
                header_extra = reorder_header
            else:
                values, header_extra = map_np.craft_reorder(values,
                                                            self.fidelity)
        D = self.sections
        B, n_sec = section_lengths(n, D)
        vals = np.zeros(D * B, dtype=np.uint32)
        vals[:n] = values
        x = torch.from_numpy(vals.view(np.int32)).to(self.device)

        sigma_cap = self._sigma_cap or (int(values.max()) + 1)
        if hist_override is not None:
            sigma_cap = max(sigma_cap, len(hist_override))
        mapped, k, low, hist = self._map_hist(x, sigma_cap)
        if hist_override is None:
            freqs = hist.cpu().numpy().astype(np.uint64)
            # the device pass histograms the zero padding too; remove it
            # so that the model reflects the data
            freqs[self._padding_symbol()] -= np.uint64(D * B - n)
        else:
            freqs = np.asarray(hist_override).astype(np.uint64)
        max_sym = int(np.flatnonzero(freqs)[-1])
        nfreqs = adjust_freqs(freqs, max_sym, self.kind != "int",
                              self.h_approx, lane.lane_frame_cap(None))
        prelude = serialize_prelude(nfreqs, int(nfreqs.sum()))
        # identity kind over a huge live alphabet: the tail escape (the
        # frame folds, the prelude stays true; decode re-derives the plan)
        plan = escape.plan_from_freqs(nfreqs) if self.kind == "int" else None
        if plan is not None:
            m_np, k_np, _ = plan.map_values(vals)
            mapped = torch.from_numpy(m_np.view(np.int32)).to(self.device)
            k = torch.from_numpy(k_np.astype(np.int32)).to(self.device)
            low = x & 0xFFFFFF
            frame_freqs = plan.frame_freqs
        else:
            frame_freqs = nfreqs
        table, rank_of = lane.scan_table(
            frame_freqs, self.kind == "int" and plan is None, self.device)

        S = self.lanes or config.default_lane_count(B)
        T = lane_codec.lane_steps(B, S)
        staged = [_stage_sections(t, D, B, T, S) for t in (
            lane.to_ranks(mapped, rank_of), k, low)]
        head = (_HEADER.pack(MAGIC, VERSION, KINDS[self.kind], self.fidelity,
                             self.h_approx, n, D)
                + bytes(header_extra) + struct.pack("<I", len(prelude))
                + prelude)
        joint = production_engine_ok(frame_freqs, S,
                                     grouped.use_grouped_layout(frame_freqs))
        return (head, staged, torch.from_numpy(n_sec).to(self.device), table,
                joint)

    def encode(self, values, hist_override=None,
               reorder_header=None) -> bytes:
        """The ATFB container of `values`: one scan launch and one
        placement launch for all sections.  hist_override: a precomputed
        global symbol histogram (several processes' allreduce, so that
        every shard derives the same model).  reorder_header: for rfold,
        the wire header of a reorder already applied to `values` (derived
        from global counts; a local remap here would disagree between
        shards).  ans_tpu's `premapped` (a prior device pass handed back
        in) is not ported."""
        head, staged, n_sec, table, joint = self._front(
            values, hist_override, reorder_header)
        stream, offsets, _, states = engine.encode_streams(*staged, n_sec,
                                                           table)
        return _container(head, stream, offsets.cpu().numpy(), states,
                          joint)

    def prepare_encoder(self, values):
        """Stage `values` for repeated encodes of the container on the
        device: a PreparedBlockEncoder; `pe.to_bytes(*pe())` equals
        encode(values)."""
        head, staged, n_sec, table, joint = self._front(values)
        return PreparedBlockEncoder(head, joint, *staged, n_sec.cpu(),
                                    table)

    # -- decode -----------------------------------------------------------

    def prepare_decoder(self, blob: bytes, n: int | None = None,
                        engine_name: str | None = None):
        """Stage a container's D sections on the device as one batch: an
        engine.PreparedBatchDecoder (call it to run one decode launch for
        all sections; its to_host gives the values in order).
        `engine_name` forces "search", "grouped" or "direct"."""
        magic, _ver, kind_id, fid, _h, n_stored, D = _HEADER.unpack_from(
            blob, 0)
        if magic != MAGIC:
            raise ValueError("not an ATFB container")
        kind = _KIND_NAMES[kind_id]
        if kind != self.kind or fid != self.fidelity:
            raise ValueError(
                f"container method {kind}/{fid} does not match codec "
                f"{self.kind}/{self.fidelity}")
        if n is not None and n != n_stored:
            # the stream is cut into D sections of ceil(n_stored / D); a
            # different n re-derives a different split and silently
            # interleaves wrong ranges
            raise ValueError(
                f"ATFB containers are not prefix-decodable: n={n} != "
                f"stored n={n_stored}")
        pos = _HEADER.size
        mf = None
        if kind == "rfold":
            mf, pos = lane.parse_reorder(blob, fid, pos)
        (plen,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        nfreqs, _ = load_prelude(blob[pos:pos + plen + 8])
        pos += plen
        table = (self._codec._table(nfreqs, mf) if kind == "rfold"
                 else self._codec._table(nfreqs))

        B, n_sec = section_lengths(n_stored, D)
        payloads, states = [], []
        S = None
        for _ in range(D):
            (slen,) = struct.unpack_from("<I", blob, pos)
            pos += 4
            S_d, st, pay, _t_sec, sec_len = framing.parse(
                blob[pos:pos + slen], 0)
            pos += slen
            if S is not None and S_d != S:
                raise ValueError("corrupt ATFB container: sections of "
                                 f"{S} and {S_d} lanes")
            if int(np.sum(sec_len)) != len(pay):
                raise ValueError("corrupt lane header: section lengths do "
                                 "not sum to the stream length")
            S = S_d
            payloads.append(pay)
            states.append(st)
        return engine.PreparedBatchDecoder(
            payloads, np.stack(states), table, n_sec, S=S,
            T=lane_codec.lane_steps(B, S), device=self.device,
            engine=engine_name)

    def decode(self, blob: bytes, n: int | None = None) -> np.ndarray:
        prep = self.prepare_decoder(blob, n)
        return prep.to_host(prep())


class PreparedBlockEncoder(engine.PreparedBatchEncoder):
    """A container's sections staged for repeated encodes: each call runs
    one scan launch and one placement launch for all of them, and
    `to_bytes(stream, states)` writes the container."""

    def __init__(self, head: bytes, joint: bool, *args):
        super().__init__(*args)
        self.head, self.joint = head, joint

    def to_bytes(self, stream: torch.Tensor, states: torch.Tensor) -> bytes:
        return _container(self.head, stream, self.offsets, states,
                          self.joint)


def _container(head: bytes, stream: torch.Tensor, offsets: np.ndarray,
               states: torch.Tensor, joint: bool) -> bytes:
    """The container: `head`, then each section's u32 length and fmt-2
    blob, its stream cut (sections of t_sec steps) by one t_sec for all
    (joint) or each on its own.  offsets: (D, T + 1) host i64, each step's
    offset in `stream`, then the section's end."""
    D, T = offsets.shape[0], offsets.shape[1] - 1
    stream = stream.cpu().numpy()
    states = states.cpu().numpy().view(np.uint32)
    starts, ends = offsets[:, 0], offsets[:, T]
    bases = [offsets[d, :T] - starts[d] for d in range(D)]
    totals = [int(e - s) for s, e in zip(starts, ends)]
    if joint:
        t_sec, sec_lens = framing.choose_sections_joint(bases, totals, T)
        cuts = [(t_sec, sl) for sl in sec_lens]
    else:
        cuts = [framing.choose_sections(b, tot, T)
                for b, tot in zip(bases, totals)]
    out = bytearray(head)
    for d, (t_sec, sec_len) in enumerate(cuts):
        sec = framing.pack(states[d], stream[starts[d]:ends[d]], t_sec,
                           sec_len)
        out += struct.pack("<I", len(sec)) + sec
    return bytes(out)


def _stage_sections(t: torch.Tensor, D: int, B: int, T: int, S: int):
    """(D * B,) i32 -> (D, T, S): each section's B positions padded with
    zeros to T * S."""
    out = torch.zeros((D, T * S), dtype=torch.int32, device=t.device)
    out[:, :B] = t.reshape(D, B)
    return out.reshape(D, T, S)


def encode_blocked(values, method="ANSfold-2", sections=1, lanes=None, *,
                   device):
    return BlockCodec(method, sections, lanes, device=device).encode(values)


def decode_blocked(blob, n=None, method="ANSfold-2", *, device):
    return BlockCodec(method, device=device).decode(blob, n)
