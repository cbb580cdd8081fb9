"""Pseudo-adaptive block ANS (ATFP) on one device (counterpart of
ans_tpu/models/pseudo_adaptive.py).

The input is cut into blocks of `block_size` values; each block stores its
own dense alphabet (interp-coded sorted symbol set) and codes the ranks of
its values under its own model, so block models follow local statistics.
Single-symbol blocks skip entropy coding.  ans_tpu codes the lane blocks
one after the other; here they are batches of streams with a model each
(ops/model_batch.py): the blocks that take the same encode scan (K1 or
K6) at the same lane count are one scan launch and one placement launch
(K2), and the blocks that take the same decode engine (K3, K4 or K5) at
the same lane count, step count and instance are one decode launch.  The
ranks go back to values by one gather on the device over the blocks'
alphabets, laid one after the other.  Blocks below 2^16 values (or
engine="compat") are coded on the host by the compat coders
(reference_model/rans_compat.py); no kernel runs for them.

Container (the ans_tpu writer's bytes):
    u32 magic "ATFP" | u8 ver (2) | u8 kind (0=int, 1=msb)
    | u8 engine (0=compat, 1=lane; ver >= 2) | u8 rsvd
    | u32 n | u32 block_size
per block: u32 blob_len | vbyte(sigma_b) |
    sigma_b == 1 ? vbyte(symbol)
                 : vbyte(max_sym_b) | interp(alphabet) | ANS blob
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import decode as dec_ops, lane_codec, model_batch
from ..reference_model import interp, rans_compat, vbyte
from . import ans as lane, config, engine as eng, framing

MAGIC = 0x41544650  # "PFTA" little-endian -> "ATFP"
VERSION = 2
KINDS = ("int", "msb")
ENGINES = ("auto", "lane", "compat")
LANE_FROM = 1 << 16  # the auto rule: lane blocks from this size up

_HEADER = struct.Struct("<IBBBBII")

# decode engine -> the kernel its batches launch
_KERNEL = {"search": "decode_search", "direct": "decode_direct",
           "grouped": "decode_grouped"}


def resolve_engine(engine: str, block_size: int) -> str:
    """The block engine of a container: `engine`, or under "auto" the lane
    engine from 2^16 values a block up (ans_tpu's rule)."""
    if engine != "auto":
        return engine
    return "lane" if block_size >= LANE_FROM else "compat"


def _compat_codec(kind: str):
    return rans_compat.AnsInt() if kind == "int" else rans_compat.AnsMsb()


def _alphabet_head(alpha: np.ndarray) -> bytes:
    """vbyte(sigma) | vbyte(max) | interp(alphabet) of a block's sorted
    alphabet of two or more symbols."""
    max_sym = int(alpha[-1])
    return (vbyte.encode_u32(len(alpha)) + vbyte.encode_u32(max_sym)
            + interp.encode(alpha, len(alpha), max_sym + 1))


@dataclass
class _LaneBlock:
    """A lane block's encode staging: its header bytes (alphabet and
    prelude), length, lane count and steps, the scan's table (on the
    host's CPU) and the (n,) i32 scan inputs."""

    index: int
    head: bytes
    n: int
    S: int
    T: int
    table: object
    syms: torch.Tensor
    nb: torch.Tensor
    excw: torch.Tensor


class PseudoAdaptive:
    """Block codec with per-block alphabets and models on `device`:
    blocks of `block_size` values of `kind` ("int": AnsInt over the ranks,
    "msb": AnsMsb), `lanes` lanes a lane block (None: its default lane
    count), `engine` "lane", "compat" or "auto" (lane from 2^16 values a
    block up)."""

    def __init__(self, block_size: int = 128 * 1024, kind: str = "int",
                 lanes: int | None = None, engine: str = "auto", *, device):
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got "
                             f"{engine!r}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.kind = kind
        self.lanes = config.validate_lanes(lanes)
        self.engine = engine
        self.device = torch.device(device)
        self.name = f"pseudo_adaptive-{kind}-{block_size}"

    def _lane_codec(self, kind: str, device):
        cls = lane.AnsInt if kind == "int" else lane.AnsMsb
        return cls(lanes=self.lanes, device=device)

    def _header(self, n: int, engine: str) -> bytes:
        return _HEADER.pack(MAGIC, VERSION, KINDS.index(self.kind),
                            0 if engine == "compat" else 1, 0, n,
                            self.block_size)

    # -- encode -----------------------------------------------------------

    def encode(self, values) -> bytes:
        values = np.ascontiguousarray(values, dtype=np.uint32)
        if len(values) == 0:
            raise ValueError("cannot encode an empty sequence")
        engine = resolve_engine(self.engine, self.block_size)
        if engine == "compat":
            return self._encode_compat(values)
        heads, blocks = self._stage(values)
        out = {}
        for batch in _encode_batches(blocks, self.device):
            stream, offsets, _, states = eng.encode_streams(
                batch.mapped, batch.nb, batch.excw, batch.lengths,
                batch.table)
            out.update(_lane_blobs(batch.blocks, stream,
                                   offsets.cpu().numpy(), states))
        return self._container(len(values), heads, out)

    def _encode_compat(self, values: np.ndarray) -> bytes:
        codec = _compat_codec(self.kind)
        out = bytearray(self._header(len(values), "compat"))
        for off in range(0, len(values), self.block_size):
            block = values[off:off + self.block_size]
            alpha = np.unique(block)
            if len(alpha) == 1:
                blob = vbyte.encode_u32(1) + vbyte.encode_u32(int(alpha[0]))
            else:
                blob = _alphabet_head(alpha) + codec.encode(
                    np.searchsorted(alpha, block).astype(np.uint32))
            out += struct.pack("<I", len(blob)) + blob
        return bytes(out)

    def _stage(self, values: np.ndarray):
        """The model half of a lane encode, block by block on the host:
        (each block's bytes in front of its lane blob, or all of a
        single-symbol block's, in order; the lane blocks' staging)."""
        codec = self._lane_codec(self.kind, "cpu")
        heads, blocks = [], []
        for i, off in enumerate(range(0, len(values), self.block_size)):
            block = values[off:off + self.block_size]
            alpha = np.unique(block)
            if len(alpha) == 1:
                heads.append(vbyte.encode_u32(1)
                             + vbyte.encode_u32(int(alpha[0])))
                continue
            ranks = np.searchsorted(alpha, block).astype(np.uint32)
            mapped, k, low, pfreqs, ffreqs, raw, _ = codec._enc_inputs(ranks)
            table, rank_of = lane.scan_table(ffreqs, raw, "cpu")
            n = len(block)
            S = self.lanes or config.default_lane_count(n)
            heads.append(_alphabet_head(alpha) + codec._prelude(pfreqs))
            blocks.append(_LaneBlock(
                index=i, head=heads[-1], n=n, S=S,
                T=lane_codec.lane_steps(n, S), table=table,
                syms=lane.to_ranks(mapped, rank_of), nb=k, excw=low))
        return heads, blocks

    def _container(self, n: int, heads, lane_blobs: dict) -> bytes:
        """The container: the header, then each block's u32 length and its
        bytes (the head, then its lane blob where it has one)."""
        out = bytearray(self._header(n, "lane"))
        for i, head in enumerate(heads):
            blob = head + lane_blobs.get(i, b"")
            out += struct.pack("<I", len(blob)) + blob
        return bytes(out)

    def prepare_encoder(self, values):
        """Stage `values` for repeated encodes on the device: a
        PreparedPseudoEncoder; `pe.to_bytes(pe())` equals encode(values).
        Lane containers only."""
        values = np.ascontiguousarray(values, dtype=np.uint32)
        if len(values) == 0:
            raise ValueError("cannot encode an empty sequence")
        if resolve_engine(self.engine, self.block_size) == "compat":
            raise ValueError("compat blocks are coded on the host: call "
                             "encode()")
        heads, blocks = self._stage(values)
        return PreparedPseudoEncoder(self, len(values), heads, blocks)

    # -- decode -----------------------------------------------------------

    def decode(self, blob: bytes, n: int | None = None) -> np.ndarray:
        """The values of an ATFP container of any kind and engine (both
        come from its header)."""
        blob = memoryview(blob).tobytes()
        head = _parse_header(blob, n)
        if head["engine"] == "compat":
            return self._decode_compat(blob, head)
        prep = self._prepare_decoder(blob, head)
        return prep.to_host(prep())

    def _decode_compat(self, blob: bytes, head: dict) -> np.ndarray:
        codec = _compat_codec(head["kind"])
        n, out = head["n"], np.empty(head["n"], dtype=np.uint32)
        for off, blen, pos, clen in _blocks(blob, n, head["block_size"]):
            body = blob[pos:pos + clen + 8]  # +8: interp may overread
            sigma, p = vbyte.decode_u32(body, 0)
            if sigma == 1:
                out[off:off + blen] = vbyte.decode_u32(body, p)[0]
                continue
            max_sym, p = vbyte.decode_u32(body, p)
            alpha, words = interp.decode(body, sigma, max_sym + 1,
                                         bit_offset=p * 8)
            # the stream slice must END exactly at the block boundary (the
            # compat engine anchors its final states there)
            ranks = codec.decode(blob[pos + p + words * 4:pos + clen], blen)
            out[off:off + blen] = np.asarray(alpha, dtype=np.uint32)[ranks]
        return out

    def prepare_decoder(self, blob: bytes, n: int | None = None):
        """Stage a lane container for repeated decodes on the device: a
        PreparedPseudoDecoder (call it to run one decode launch per batch
        and the gather; its to_host gives the values)."""
        blob = memoryview(blob).tobytes()
        head = _parse_header(blob, n)
        if head["engine"] == "compat":
            raise ValueError("compat blocks are decoded on the host: call "
                             "decode()")
        return self._prepare_decoder(blob, head)

    def _prepare_decoder(self, blob: bytes, head: dict):
        codec = self._lane_codec(head["kind"], "cpu")
        n, bs = head["n"], head["block_size"]
        alphas, single, groups = [], {}, {}
        for b, (off, blen, pos, clen) in enumerate(_blocks(blob, n, bs)):
            body = blob[pos:pos + clen + 8]
            sigma, p = vbyte.decode_u32(body, 0)
            if sigma == 1:
                single[b] = (off, blen, vbyte.decode_u32(body, p)[0])
                continue
            max_sym, p = vbyte.decode_u32(body, p)
            alpha, words = interp.decode(body, sigma, max_sym + 1,
                                         bit_offset=p * 8)
            buf = blob[pos + p + words * 4:pos + clen]
            table, at = codec._dec_table(buf)
            S, states, payload, _, sec_len = framing.parse(buf, at)
            if int(np.sum(sec_len)) != len(payload):
                raise ValueError("corrupt lane header: section lengths do "
                                 "not sum to the stream length")
            engine = eng.choose_decode_engine(table, S)
            dev = eng.dec_device_table(table, engine, "cpu")
            instance, _, _ = dec_ops.launch_plan(_KERNEL[engine], dev, S)
            T = lane_codec.lane_steps(blen, S)
            groups.setdefault((engine, S, T, instance), []).append(
                (b, off, blen, payload, states, dev))
            alphas.append((b, np.asarray(alpha, dtype=np.uint32)))
        return PreparedPseudoDecoder(n, bs, alphas, single, groups,
                                     self.device)


def _parse_header(blob: bytes, n: int | None) -> dict:
    magic, ver, kind_id, eng_id, _, n_stored, bs = _HEADER.unpack_from(blob)
    if magic != MAGIC:
        raise ValueError("not an ATFP container")
    # ver 1 containers did not record the engine: the auto rule over the
    # stored block size gives it
    engine = (("compat", "lane")[eng_id] if ver >= 2
              else resolve_engine("auto", bs))
    return {"kind": KINDS[kind_id], "engine": engine, "block_size": bs,
            "n": n_stored if n is None else n}


def _blocks(blob: bytes, n: int, bs: int):
    """(first value, length, offset of the body, body length) of each
    block of a container."""
    pos, off = _HEADER.size, 0
    while off < n:
        blen = min(bs, n - off)
        (clen,) = struct.unpack_from("<I", blob, pos)
        yield off, blen, pos + 4, clen
        pos += 4 + clen
        off += blen


@dataclass
class _EncodeBatch:
    """Lane blocks that take one scan launch and one placement launch:
    their (D, T, S) staged inputs, lengths and models, on the device."""

    blocks: list
    mapped: torch.Tensor
    nb: torch.Tensor
    excw: torch.Tensor
    lengths: torch.Tensor
    table: model_batch.ModelBatch


def _encode_batches(blocks, device) -> list:
    """The lane blocks grouped by what a scan launch fixes (the scan, K1 or
    K6, and the lane count), each group staged on `device`: T the longest
    block's steps, each block its own length and model."""
    groups = {}
    for blk in blocks:
        groups.setdefault((type(blk.table), blk.S), []).append(blk)
    out = []
    for (_, S), blks in groups.items():
        T = max(b.T for b in blks)
        staged = []
        for name in ("syms", "nb", "excw"):
            t = torch.zeros((len(blks), T * S), dtype=torch.int32)
            for d, b in enumerate(blks):
                t[d, :b.n] = getattr(b, name)
            staged.append(t.reshape(len(blks), T, S).to(device))
        out.append(_EncodeBatch(
            blocks=blks, mapped=staged[0], nb=staged[1], excw=staged[2],
            lengths=torch.tensor([b.n for b in blks],
                                 dtype=torch.int64).to(device),
            table=model_batch.stack([b.table for b in blks], device)))
    return out


def _lane_blobs(blocks, stream: torch.Tensor, offsets: np.ndarray,
                states: torch.Tensor) -> dict:
    """Each block's fmt-2 lane blob from its batch's stream, cut into
    sections by its own step offsets (framing.choose_sections, as the
    one-stream encode cuts it): block index -> bytes."""
    stream = stream.cpu().numpy()
    states = states.cpu().numpy().view(np.uint32)
    T = offsets.shape[1] - 1
    out = {}
    for d, blk in enumerate(blocks):
        start, end = int(offsets[d, 0]), int(offsets[d, T])
        t_sec, sec_len = framing.choose_sections(
            offsets[d, :blk.T] - start, end - start, blk.T)
        out[blk.index] = framing.pack(states[d], stream[start:end], t_sec,
                                      sec_len)
    return out


class PreparedPseudoEncoder:
    """A lane container's blocks staged on the device in their batches:
    each call runs one scan launch and one placement launch a batch
    (engine.PreparedBatchEncoder, whose priming run fixed each block's
    step offsets) and returns each batch's (stream, states);
    `to_bytes(outs)` writes the container."""

    def __init__(self, codec: PseudoAdaptive, n: int, heads, blocks):
        self.codec, self.n, self.heads = codec, n, heads
        self.batches = []
        for batch in _encode_batches(blocks, codec.device):
            pe = eng.PreparedBatchEncoder(batch.mapped, batch.nb,
                                          batch.excw,
                                          [b.n for b in batch.blocks],
                                          batch.table)
            self.batches.append((batch.blocks, pe))

    def __call__(self):
        return [pe() for _, pe in self.batches]

    def to_bytes(self, outs) -> bytes:
        blobs = {}
        for (blocks, pe), (stream, states) in zip(self.batches, outs):
            blobs.update(_lane_blobs(blocks, stream, pe.offsets, states))
        return self.codec._container(self.n, self.heads, blobs)


class PreparedPseudoDecoder:
    """A lane container staged on the device: its lane blocks in batches
    of one decode engine, lane count, step count and instance (one
    engine.PreparedBatchDecoder each, a model a block), the blocks'
    alphabets one after the other, and the single-symbol blocks' values.
    A call runs one decode launch a batch and the gather of every rank to
    its value; it returns the (n,) i32 device tensor.  A batch of full
    blocks that follow each other in the container (every batch but a
    ragged last block's, when the blocks take one route) gathers straight
    into its span of the output: one add and one index_select."""

    def __init__(self, n: int, bs: int, alphas, single: dict, groups: dict,
                 device):
        self.n, self.bs = n, bs
        self.device = torch.device(device)
        self.nfull = n // bs  # blocks of bs values
        cat = (np.concatenate([a for _, a in alphas]) if alphas
               else np.zeros(0, np.uint32))
        self.alphabet = torch.from_numpy(cat.view(np.int32)).to(self.device)
        starts = np.cumsum([0] + [len(a) for _, a in alphas])
        alpha_at = {b: int(s) for (b, _), s in zip(alphas, starts)}

        def on_device(values):
            return torch.tensor(values, dtype=torch.int32).to(self.device)

        self.batches = []
        for (engine, S, T, _), members in groups.items():
            blocks = [m[0] for m in members]
            dec = eng.PreparedBatchDecoder(
                [m[3] for m in members], np.stack([m[4] for m in members]),
                model_batch.stack([m[5] for m in members], self.device),
                [m[2] for m in members], S=S, T=T, device=self.device,
                engine=engine)
            full = [d for d, m in enumerate(members) if m[2] == bs]
            batch = {"decoder": dec,
                     "at": on_device([[alpha_at[blocks[d]]] for d in full]),
                     "short": [(d, m[1], m[2], alpha_at[m[0]])
                               for d, m in enumerate(members)
                               if m[2] != bs]}
            first = blocks[0]
            if full == list(range(len(members))) and blocks == list(
                    range(first, first + len(blocks))):
                batch["span"] = (first * bs, (first + len(blocks)) * bs)
            else:
                batch["full"] = on_device(full).long()
                batch["rows"] = on_device([blocks[d] for d in full]).long()
            self.batches.append(batch)
        fill = [(b, sym) for b, (_, blen, sym) in single.items()
                if blen == bs]
        self.fill_blocks = on_device([b for b, _ in fill]).long()
        self.fill_values = torch.from_numpy(np.asarray(
            [s for _, s in fill], dtype=np.uint32).view(np.int32)).to(
            self.device)
        self.fill_short = [(off, blen, int(np.uint32(sym).view(np.int32)))
                           for off, blen, sym in single.values()
                           if blen != bs]
        self.engines = [b["decoder"].engine for b in self.batches]

    def __call__(self) -> torch.Tensor:
        out = torch.empty(self.n, dtype=torch.int32, device=self.device)
        rows = out[:self.nfull * self.bs].view(self.nfull, self.bs)
        for b in self.batches:
            ranks = b["decoder"]()
            flat = ranks.reshape(ranks.shape[0], -1)
            if "span" in b:
                idx = flat[:, :self.bs] + b["at"]
                start, stop = b["span"]
                torch.index_select(self.alphabet, 0, idx.view(-1),
                                   out=out[start:stop])
            elif b["full"].numel():
                idx = flat[b["full"], :self.bs] + b["at"]
                rows[b["rows"]] = self.alphabet[idx]
            for d, off, blen, at in b["short"]:
                out[off:off + blen] = self.alphabet[flat[d, :blen] + at]
        if self.fill_blocks.numel():
            rows[self.fill_blocks] = self.fill_values[:, None]
        for off, blen, sym in self.fill_short:
            out[off:off + blen] = sym
        return out

    def to_host(self, out: torch.Tensor) -> np.ndarray:
        return out.cpu().numpy().view(np.uint32)
