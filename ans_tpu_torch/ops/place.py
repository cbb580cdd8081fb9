"""K2, the placement (csrc/place.cu), and its wrapper.

Replaces ans_tpu/ops/pallas_place.py `place` + `sections_to_stream`: the
stream comes out flat, since sections are contiguous slices of it."""

from __future__ import annotations

import ctypes as ct

import torch

from ..csrc import build
from .lane_codec import NROUNDS, place_plain

# launches of the CUDA kernel (never counts the plain version)
launches = 0

_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_int,
             ct.c_int, ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_void_p,
             ct.c_void_p]


def place(packed: torch.Tensor, nb: torch.Tensor, excw: torch.Tensor,
          n: int, round_base: torch.Tensor, total: int) -> torch.Tensor:
    """Bytes of the encode scan into the (total,) u8 fmt-2 stream.

    packed/nb/excw: (T, S) i32 (scan words, exception-byte counts, the
    values' three low bytes); round_base: (T*6,) i64 from
    lane_codec.encode_totals.  CPU tensors run the plain version
    (lane_codec.place_plain); CUDA tensors launch the kernel."""
    global launches
    T, S = packed.shape
    for name, t in (("packed", packed), ("nb", nb), ("excw", excw)):
        if t.shape != (T, S) or t.dtype != torch.int32:
            raise ValueError(f"place: {name} must be a ({T}, {S}) int32 "
                             "tensor")
    if round_base.shape != (T * NROUNDS,) or round_base.dtype != torch.int64:
        raise ValueError(f"place: round_base must be a ({T * NROUNDS},) "
                         "int64 tensor")
    tensors = (packed, nb, excw, round_base)
    if all(t.device.type == "cpu" for t in tensors):
        return place_plain(packed, nb, excw, n, round_base, total)
    dev = build.require_cuda("place", *tensors)
    stream = torch.empty(total, dtype=torch.uint8, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = build.function("place", _ARGTYPES)
    build.check("place", fn(
        build.ptr(packed), build.ptr(nb), build.ptr(excw), n, T, S,
        build.ptr(round_base), build.ptr(stream), total, build.ptr(err),
        build.current_stream(dev)))
    launches += 1
    if err.item():
        raise ValueError("place: a byte position passes the stream "
                         "length (round_base disagrees with the words)")
    return stream
