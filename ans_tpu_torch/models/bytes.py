"""Byte-level codecs on PyTorch (counterpart of ans_tpu/models/bytes.py):
the vbyte and streamvbyte splitters, the AnsByte entropy coder and the
split + entropy composites vbyteANS and streamvbyteANS.

The splitters run K7-K9 (ops/bytesplit.py); AnsByte codes the 256-symbol
alphabet on the lane engine like every other lane codec (no exception
bytes: the decoded word is the byte itself), with the byte coder's own
model (reference_model/byte_model.py).  A composite keeps the split
stream on the device between its two stages.

Wire: vbyte is the plain varint stream; streamvbyte is ceil(n/4) control
bytes, then the data bytes; a composite is a u32 little-endian count of
split bytes, then the AnsByte blob (byte prelude, then the fmt-2 lane
stream, at the default lane count of the split stream).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bytesplit, tables
from ..reference_model.byte_model import (byte_adjust_freqs,
                                          byte_prelude_decode,
                                          byte_prelude_serialize)
from . import config
from .ans import _LaneCodec, _to_device


def _bytes_to_device(buf, device) -> torch.Tensor:
    """A bytes-like object -> (len,) u8 tensor on `device`."""
    arr = np.frombuffer(buf, dtype=np.uint8)
    return torch.from_numpy(arr.copy()).to(device)


def _values_to_host(x: torch.Tensor) -> np.ndarray:
    """(n,) i32 bit patterns on a device -> host u32 array."""
    return x.cpu().numpy().view(np.uint32)


class Vbyte:
    """7-bit varint splitter (reference: methods.hpp:38-59), run on
    `device`: K7 encodes, K9 decodes."""

    name = "vbyte"

    def __init__(self, *, device):
        self.device = torch.device(device)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """(n,) i32 values on the device -> the (total,) u8 stream."""
        return bytesplit.vbyte_encode(x)

    def join(self, stream: torch.Tensor, n: int) -> torch.Tensor:
        """A (L,) u8 stream on the device -> its first n values, i32."""
        return bytesplit.vbyte_decode(stream, n)

    def encode(self, values) -> bytes:
        return self.split(_to_device(values, self.device)).cpu().numpy(
            ).tobytes()

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        return _values_to_host(self.join(_bytes_to_device(buf, self.device),
                                         n))


class StreamVbyte(Vbyte):
    """2-bit-key byte splitter (reference: methods.hpp:89-102), run on
    `device`: K7 encodes (data and control bytes), K8 decodes."""

    name = "streamvbyte"

    def split(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat(bytesplit.svb_encode(x))

    def join(self, stream: torch.Tensor, n: int) -> torch.Tensor:
        nc = -(-n // 4)
        return bytesplit.svb_decode(stream[:nc], stream[nc:], n)


class AnsByte(_LaneCodec):
    """S-lane rANS over the byte alphabet (reference: ans_byte.hpp:99-300),
    run on `device`.  The byte coder's model (byte_adjust_freqs, a raw
    256-entry interp prelude over universe 4096 + 256) in front of the
    fmt-2 lane stream.  Operates on byte strings: encode(bytes) -> bytes,
    decode(buf, n) -> bytes; encode_tensor and decode_tensor take and
    give the bytes as a u8 tensor on the device."""

    name = "ansbyte"

    def __init__(self, lanes: int | None = None, *, device):
        self.lanes = config.validate_lanes(lanes)
        self.device = torch.device(device)

    def _enc_inputs(self, data: torch.Tensor):
        """(mapped, k, low, nfreqs, nfreqs, raw=True, header=b"") for a
        (n,) u8 device tensor: the symbols are the bytes, with no exception
        bytes."""
        if data.numel() == 0:
            raise ValueError("cannot encode an empty sequence")
        mapped = data.to(torch.int32)
        hist = torch.bincount(mapped, minlength=256)
        nfreqs = byte_adjust_freqs(hist.cpu().numpy().astype(np.uint64))
        zero = torch.zeros_like(mapped)
        return mapped, zero, zero, nfreqs, nfreqs, True, b""

    def _prelude(self, pfreqs) -> bytes:
        return byte_prelude_serialize(pfreqs)

    def _table(self, nfreqs):
        return tables.build_dec_table(np.asarray(nfreqs, dtype=np.uint32))

    def _dec_table(self, buf: bytes):
        nfreqs, off = byte_prelude_decode(buf)
        return self._table(nfreqs), off

    def encode_tensor(self, data: torch.Tensor) -> bytes:
        return super().encode(data)

    def decode_tensor(self, buf: bytes, n: int) -> torch.Tensor:
        prep = self.prepare_decoder(buf, n)
        return prep().reshape(-1)[:n].to(torch.uint8)

    def encode(self, data: bytes) -> bytes:
        return self.encode_tensor(_bytes_to_device(data, self.device))

    def decode(self, buf: bytes, n: int) -> bytes:
        return self.decode_tensor(buf, n).cpu().numpy().tobytes()


class _SplitPlusByteEntropy:
    """Byte-split + byte-entropy composite (reference: methods.hpp:432-482,
    the vbyteANS / streamvbyteANS shape): a u32 count of split bytes, then
    the entropy-coded split stream."""

    def __init__(self, split, entropy, name: str):
        self.split = split
        self.entropy = entropy
        self.name = name
        self.device = split.device

    def encode(self, values) -> bytes:
        stream = self.split.split(_to_device(values, self.device))
        return (int(stream.numel()).to_bytes(4, "little")
                + self.entropy.encode_tensor(stream))

    def decode(self, buf: bytes, n: int) -> np.ndarray:
        buf = memoryview(buf).tobytes()
        nb = int.from_bytes(buf[0:4], "little")
        stream = self.entropy.decode_tensor(buf[4:], nb)
        return _values_to_host(self.split.join(stream, n))


def VbyteAns(lanes: int | None = None, *, device):
    return _SplitPlusByteEntropy(Vbyte(device=device),
                                 AnsByte(lanes, device=device), "vbyteANS")


def StreamVbyteAns(lanes: int | None = None, *, device):
    return _SplitPlusByteEntropy(StreamVbyte(device=device),
                                 AnsByte(lanes, device=device),
                                 "streamvbyteANS")
