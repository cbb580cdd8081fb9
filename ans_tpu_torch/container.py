"""Self-describing single-stream file container ("ATFC"), a copy of
ans_tpu/container.py over the port's registry: the same wire, so that
each package reads the other's files.

The codec wire formats are deliberately headerless (decode is
size-directed and method-directed, matching the reference's API, so
blobs stay byte-comparable with the C++ output).  For files that must
decode without out-of-band knowledge, this envelope records what the
caller would otherwise pass:

    u32 magic 0x41544643 ("ATFC") | u8 version(1) | u8 engine
    u8 name_len | name (ascii, registry method name)
    u64 n (element count) | u64 blob_len | blob (codec wire bytes)

engine: 0 = compat (reference wire), 1 = lane (the S-lane wire).  Any
registry method is valid: the envelope stores the name, not a code, so
new methods need no format change.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x41544643
_ENGINES = ("compat", "lane")


def pack(method: str, engine: str, n: int, blob: bytes) -> bytes:
    name = method.encode("ascii")
    if not 1 <= len(name) <= 255:
        raise ValueError(f"bad method name {method!r}")
    head = struct.pack("<IBBB", MAGIC, 1, _ENGINES.index(engine),
                       len(name))
    return head + name + struct.pack("<QQ", n, len(blob)) + bytes(blob)


def unpack(buf: bytes):
    """(method, engine, n, blob) from an ATFC container."""
    buf = memoryview(buf)
    if len(buf) < 7:
        raise ValueError("truncated ATFC header")
    magic, ver, eng, nlen = struct.unpack_from("<IBBB", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"not an ATFC container (magic {magic:#x})")
    if ver != 1:
        raise ValueError(f"unsupported ATFC version {ver}")
    if eng >= len(_ENGINES) or nlen < 1:
        raise ValueError("corrupt ATFC header")
    if len(buf) < 7 + nlen + 16:
        raise ValueError("truncated ATFC header")
    name = bytes(buf[7:7 + nlen]).decode("ascii")
    n, blen = struct.unpack_from("<QQ", buf, 7 + nlen)
    blob = bytes(buf[7 + nlen + 16:])
    if len(blob) < blen:
        raise ValueError(f"truncated ATFC payload: header claims "
                         f"{blen} bytes, {len(blob)} present")
    return name, _ENGINES[eng], n, blob[:blen]


def compress(values, method: str = "ANSfold-2", engine: str = "lane", *,
             device="cuda", lanes: int | None = None) -> bytes:
    """The ATFC container of `values` coded by `method` under `engine`; a
    lane codec runs on `device` and writes `lanes` lanes (None: its
    default lane count)."""
    from . import models
    values = np.ascontiguousarray(values, dtype=np.uint32)
    blob = models.get(method, device=device, lanes=lanes,
                      engine=engine).encode(values)
    return pack(method, engine, len(values), blob)


def decompress(buf: bytes, *, device="cuda") -> np.ndarray:
    """The values of an ATFC container; a lane codec runs on `device`."""
    from . import models
    method, engine, n, blob = unpack(buf)
    out = models.get(method, device=device, engine=engine).decode(blob, n)
    return np.ascontiguousarray(out, dtype=np.uint32)
