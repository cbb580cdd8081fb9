"""Byte splitters: vbyte and streamvbyte, both directions.  K7 (encode,
csrc/bytesplit_encode.cu), K8 (streamvbyte decode, csrc/svb_decode.cu)
and K9 (vbyte decode, csrc/vbyte_decode.cu), their wrappers and their
plain PyTorch versions.

Replace ans_tpu/ops/pallas_bytesplit.py `split_encode` + `svb_control`,
`svb_decode` and `vbyte_decode`; the plain versions are the counterparts
of ans_tpu/ops/bytesplit.py.

Wire formats (docs/FORMAT.md):
  * vbyte: per element 7-bit groups, lowest first; bit 7 set on every
    byte but the element's last.
  * streamvbyte: ceil(n/4) control bytes (2 bits an element = data
    length - 1, element 0 of a group in the low bits, unused keys of the
    last byte 0), then each element's 1-4 little-endian data bytes.

u32 values travel as i32 bit patterns; the plain versions compute in
int64 (torch has no unsigned shifts or compares for 32-bit integers).
Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes as ct

import torch

from ..csrc import build

# launches of the CUDA kernels (never counts a plain version): K7 counts
# one per encode call of either format, K8 and K9 one per decode call
encode_launches = 0
svb_decode_launches = 0
vbyte_decode_launches = 0

MAX_ELEMENTS = 1 << 28  # keeps every stream below 2^31 bytes
TILE = 1024             # items a block of the earlier three-launch K7-K9
                        # (earlier_csrc/bytescan.cuh's TILE), which sizes
                        # their scratch in bench_steps
ENCODE_CHUNK = 4096     # elements a block of K7 takes, stream bytes a
DECODE_CHUNK = 8192     # block of K9, and elements a block of K8: the CHUNK
SVB_CHUNK = 4096        # of csrc/bytesplit_encode.cu, csrc/vbyte_decode.cu
                        # and csrc/svb_decode.cu, which sizes the scratch


def _check_values(name: str, x: torch.Tensor) -> int:
    if x.dim() != 1 or x.dtype != torch.int32:
        raise ValueError(f"{name}: values must be a 1-d int32 tensor")
    n = x.numel()
    if n == 0:
        raise ValueError("cannot encode an empty sequence")
    if n > MAX_ELEMENTS:
        raise ValueError(f"{name}: {n} elements; at most {MAX_ELEMENTS}")
    return n


def _check_bytes(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dim() != 1 or t.dtype != torch.uint8:
            raise ValueError(f"{name}: streams must be 1-d uint8 tensors")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def _starts(ln: torch.Tensor):
    """(exclusive prefix of the lengths, their sum)."""
    end = torch.cumsum(ln, 0)
    return end - ln, int(end[-1])


def vbyte_encode_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 for vbyte: (n,) i32 -> the (total,) u8 stream."""
    v = _u32(x)
    ln = 1 + sum((v >= 1 << s).to(torch.int64) for s in (7, 14, 21, 28))
    start, total = _starts(ln)
    out = torch.zeros(total, dtype=torch.uint8, device=x.device)
    for j in range(5):
        live = j < ln
        byte = ((v >> (7 * j)) & 0x7F) | torch.where(j + 1 < ln, 0x80, 0)
        out[start[live] + j] = byte[live].to(torch.uint8)
    return out


def svb_encode_plain(x: torch.Tensor):
    """Plain version of K7 for streamvbyte: (n,) i32 -> (control
    (ceil(n/4),) u8, data (total,) u8)."""
    v = _u32(x)
    n = v.numel()
    ln = 1 + sum((v > m).to(torch.int64) for m in (0xFF, 0xFFFF, 0xFFFFFF))
    nc = -(-n // 4)
    keys = torch.zeros(nc * 4, dtype=torch.int64, device=x.device)
    keys[:n] = ln - 1
    k4 = keys.reshape(nc, 4)
    control = (k4[:, 0] | (k4[:, 1] << 2) | (k4[:, 2] << 4)
               | (k4[:, 3] << 6)).to(torch.uint8)
    start, total = _starts(ln)
    data = torch.zeros(total, dtype=torch.uint8, device=x.device)
    for j in range(4):
        live = j < ln
        data[start[live] + j] = ((v[live] >> (8 * j)) & 0xFF).to(torch.uint8)
    return control, data


def vbyte_decode_plain(data: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of K9: the first n elements of a vbyte stream as
    (n,) i32 bit patterns.  Raises ValueError when the stream holds fewer
    than n elements or one of them is longer than 5 bytes."""
    b = data.to(torch.int64)
    end = torch.nonzero((b & 0x80) == 0).reshape(-1)
    if end.numel() < n:
        raise ValueError(f"vbyte stream holds {end.numel()} elements, "
                         f"caller asked for {n}")
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=data.device)
    end = end[:n]
    start = torch.cat([end.new_zeros(1), end[:-1] + 1])
    ln = end - start + 1
    if int(ln.max()) > 5:
        raise ValueError(f"corrupt vbyte stream: {int(ln.max())}-byte "
                         f"element (u32 elements never exceed 5)")
    val = torch.zeros_like(end)
    for j in range(5):
        live = j < ln
        byte = b[torch.where(live, start + j, 0)] & 0x7F
        val |= torch.where(live, byte << (7 * j), 0)
    return (val & 0xFFFFFFFF).to(torch.int32)


_SVB_SHORT = ("corrupt streamvbyte stream: an element passes the end of "
              "the data bytes")


def svb_decode_plain(control: torch.Tensor, data: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Plain version of K8: n elements of a streamvbyte stream as (n,)
    i32 bit patterns.  Raises ValueError when the control or data bytes
    end before the n-th element does."""
    if control.numel() < -(-n // 4):
        raise ValueError("corrupt streamvbyte stream: too few control "
                         "bytes")
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=data.device)
    c = control.to(torch.int64)
    ln = torch.stack([c & 3, (c >> 2) & 3, (c >> 4) & 3, (c >> 6) & 3],
                     dim=-1).reshape(-1)[:n] + 1
    start, total = _starts(ln)
    if total > data.numel():
        raise ValueError(_SVB_SHORT)
    d = data.to(torch.int64)
    val = torch.zeros_like(ln)
    for j in range(4):
        live = j < ln
        val |= torch.where(live, d[torch.where(live, start + j, 0)]
                           << (8 * j), 0)
    return (val & 0xFFFFFFFF).to(torch.int32)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

_ENC_ARGTYPES = [ct.c_void_p, ct.c_int64, ct.c_int, ct.c_void_p, ct.c_void_p,
                 ct.c_void_p, ct.c_int64, ct.c_void_p]


def encode_chunks(n: int) -> int:
    """K7's chunks for n elements."""
    return -(-n // ENCODE_CHUNK)


def decode_chunks(length: int, address: int) -> int:
    """K9's chunks for a stream of `length` bytes at `address`: they are
    cut at 16-byte boundaries of the address space."""
    return -(-(address % 16 + length) // DECODE_CHUNK)


def svb_chunks(n: int) -> int:
    """K8's chunks for n elements."""
    return -(-n // SVB_CHUNK)


def chained_scratch(chunks: int, dev) -> torch.Tensor:
    """The scratch of K7, K8 and K9's chained scan, one allocation,
    zeroed: a status word for each chunk, the ticket, the grand total (K7's
    stream length, K8's data length, K9's terminator count) and K9's flag
    word."""
    return torch.zeros(chunks + 3, dtype=torch.int64, device=dev)


def _encode(name: str, x: torch.Tensor, vbyte: bool):
    """K7 on a CUDA tensor: (control or None, stream)."""
    global encode_launches
    n = _check_values(name, x)
    dev = build.require_cuda(name, x)
    chunks = encode_chunks(n)
    scratch = chained_scratch(chunks, dev)
    out = torch.empty((5 if vbyte else 4) * n, dtype=torch.uint8, device=dev)
    control = None if vbyte else torch.empty(-(-n // 4), dtype=torch.uint8,
                                             device=dev)
    fn = build.function("bytesplit_encode", _ENC_ARGTYPES)
    build.check("bytesplit_encode", fn(
        build.ptr(x), n, int(vbyte), build.ptr(out),
        None if vbyte else build.ptr(control), build.ptr(scratch), chunks,
        build.current_stream(dev)))
    encode_launches += 1
    return control, out[: int(scratch[chunks + 1].item())]


def vbyte_encode(x: torch.Tensor) -> torch.Tensor:
    """(n,) i32 bit patterns of u32 values -> the (total,) u8 vbyte
    stream.  CPU tensors run vbyte_encode_plain; CUDA tensors launch K7."""
    if x.device.type == "cpu":
        _check_values("vbyte_encode", x)
        return vbyte_encode_plain(x)
    return _encode("vbyte_encode", x, True)[1]


def svb_encode(x: torch.Tensor):
    """(n,) i32 bit patterns of u32 values -> (control (ceil(n/4),) u8,
    data (total,) u8).  CPU tensors run svb_encode_plain; CUDA tensors
    launch K7, which writes the control bytes too."""
    if x.device.type == "cpu":
        _check_values("svb_encode", x)
        return svb_encode_plain(x)
    return _encode("svb_encode", x, False)


_VB_DEC_ARGTYPES = [ct.c_void_p, ct.c_int64, ct.c_int64, ct.c_void_p,
                    ct.c_void_p, ct.c_int64, ct.c_void_p]


def vbyte_decode(data: torch.Tensor, n: int) -> torch.Tensor:
    """The first n elements of a (L,) u8 vbyte stream as (n,) i32 bit
    patterns.  Raises ValueError when the stream holds fewer than n
    elements or one of them is longer than 5 bytes.  CPU tensors run
    vbyte_decode_plain; CUDA tensors launch K9."""
    global vbyte_decode_launches
    _check_bytes("vbyte_decode", data)
    if data.device.type == "cpu":
        return vbyte_decode_plain(data, n)
    dev = build.require_cuda("vbyte_decode", data)
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    if data.numel() == 0:
        raise ValueError(f"vbyte stream holds 0 elements, caller asked "
                         f"for {n}")
    chunks = decode_chunks(data.numel(), data.data_ptr())
    scratch = chained_scratch(chunks, dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    fn = build.function("vbyte_decode", _VB_DEC_ARGTYPES)
    build.check("vbyte_decode", fn(
        build.ptr(data), data.numel(), n, build.ptr(out), build.ptr(scratch),
        chunks, build.current_stream(dev)))
    vbyte_decode_launches += 1
    total, flags = scratch[chunks + 1: chunks + 3].tolist()
    if flags & 1:
        raise ValueError(f"vbyte stream holds {total} elements, caller "
                         f"asked for {n}")
    if flags & 2:
        raise ValueError("corrupt vbyte stream: an element longer than 5 "
                         "bytes (u32 elements never exceed 5)")
    return out


_SVB_DEC_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_int64,
                     ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_void_p]


def svb_decode(control: torch.Tensor, data: torch.Tensor,
               n: int) -> torch.Tensor:
    """n elements of a streamvbyte stream (control (>= ceil(n/4),) u8,
    data (L,) u8) as (n,) i32 bit patterns.  Raises ValueError when the
    control or data bytes end before the n-th element does.  CPU tensors
    run svb_decode_plain; CUDA tensors launch K8."""
    global svb_decode_launches
    _check_bytes("svb_decode", control, data)
    if control.device.type == "cpu" and data.device.type == "cpu":
        return svb_decode_plain(control, data, n)
    dev = build.require_cuda("svb_decode", control, data)
    if control.numel() < -(-n // 4):
        raise ValueError("corrupt streamvbyte stream: too few control "
                         "bytes")
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    if data.numel() == 0:
        raise ValueError(_SVB_SHORT)
    chunks = svb_chunks(n)
    scratch = chained_scratch(chunks, dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    fn = build.function("svb_decode", _SVB_DEC_ARGTYPES)
    build.check("svb_decode", fn(
        build.ptr(control), build.ptr(data), data.numel(), n, build.ptr(out),
        build.ptr(scratch), chunks, build.current_stream(dev)))
    svb_decode_launches += 1
    if scratch[chunks + 1].item() > data.numel():
        raise ValueError(_SVB_SHORT)
    return out
