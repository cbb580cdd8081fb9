"""K3, the pivot-search lockstep decode (csrc/decode_search.cu), and its
wrapper.

Replaces ans_tpu/ops/pallas_decode.py `stage_search` + `_call_search`
(the direct and grouped decoders K4/K5 are not ported yet)."""

from __future__ import annotations

import ctypes as ct

import torch

from ..csrc import build
from .lane_codec import decode_search_plain
from .tables import SearchDevice

# launches of the CUDA kernel (never counts the plain version)
launches = 0

# the kernel keeps LPT = S/1024 lane states per thread in registers and
# is compiled for LPT <= 16
MAX_LANES = 1 << 14

_ARGTYPES = [ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_void_p,
             ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_int, ct.c_int,
             ct.c_int, ct.c_int, ct.c_int64, ct.c_int, ct.c_int,
             ct.c_void_p, ct.c_void_p, ct.c_void_p]


def decode_search(stream: torch.Tensor, states: torch.Tensor,
                  table: SearchDevice, n: int, T: int) -> torch.Tensor:
    """Decode T lockstep steps of S = len(states) lanes.

    stream: (L,) u8 concatenated payload; states: (S,) i32 final encoder
    states.  Returns (T, S) i32 bit patterns of the u32 values (only the
    first n positions are meaningful).  Raises ValueError when a read
    would pass the end of the stream.  CPU tensors run the plain version
    (lane_codec.decode_search_plain); CUDA tensors launch the kernel."""
    global launches
    if stream.dim() != 1 or stream.dtype != torch.uint8:
        raise ValueError("decode_search: stream must be a 1-d uint8 tensor")
    if states.dim() != 1 or states.dtype != torch.int32:
        raise ValueError("decode_search: states must be a 1-d int32 tensor")
    tensors = (stream, states, table.bases, table.high, table.nb)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_search_plain(stream, states, table, n, T)
    dev = build.require_cuda("decode_search", *tensors)
    S = states.numel()
    if S > MAX_LANES:
        raise NotImplementedError(
            f"decode_search: S = {S} lanes; the kernel takes at most "
            f"{MAX_LANES}")
    out = torch.empty((T, S), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = build.function("decode_search", _ARGTYPES)
    build.check("decode_search", fn(
        build.ptr(stream), stream.numel(), build.ptr(states),
        build.ptr(table.bases), build.ptr(table.high), build.ptr(table.nb),
        table.depth, table.sigma, table.log2m, table.NR, table.NE, n, T, S,
        build.ptr(out), build.ptr(err), build.current_stream(dev)))
    launches += 1
    if err.item():
        raise ValueError("corrupt lane stream: a read passes the end of "
                         "the stream")
    return out
