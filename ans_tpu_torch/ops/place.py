"""K2, the placement (csrc/place.cu), and its wrapper.

Replaces ans_tpu/ops/pallas_place.py `place` + `sections_to_stream`: the
stream comes out flat, since sections are contiguous slices of it, and the
kernel computes the stream offset of every step itself, in the same pass,
as the TPU kernel carries its byte cursor from one grid step to the next."""

from __future__ import annotations

import ctypes as ct

import torch

from ..csrc import build
from .lane_codec import NROUNDS, place_plain

# launches of the CUDA kernel (never counts the plain version)
launches = 0

MAX_LANES = 1 << 14  # the kernel stages 6 S bytes of a step in shared memory

_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_int,
             ct.c_int, ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_void_p,
             ct.c_void_p]


def place(packed: torch.Tensor, nb: torch.Tensor, excw: torch.Tensor,
          n: int, total: int | None = None):
    """Bytes of the encode scan into the fmt-2 stream.

    packed/nb/excw: (T, S) i32 (scan words, exception-byte counts, the
    values' three low bytes).  Returns (stream (total,) u8, step_base (T,)
    i64: the stream offset of each step, total: the stream's length).
    `total`, when given (a prepared encoder's section plan), must be what
    the words add up to, else ValueError.  CPU tensors run the plain
    version (lane_codec.place_plain); CUDA tensors launch the kernel."""
    global launches
    T, S = packed.shape
    for name, t in (("packed", packed), ("nb", nb), ("excw", excw)):
        if t.shape != (T, S) or t.dtype != torch.int32:
            raise ValueError(f"place: {name} must be a ({T}, {S}) int32 "
                             "tensor")
    tensors = (packed, nb, excw)
    if all(t.device.type == "cpu" for t in tensors):
        return place_plain(packed, nb, excw, n, total)
    dev = build.require_cuda("place", *tensors)
    if S > MAX_LANES:
        raise ValueError(f"place: at most {MAX_LANES} lanes, got {S}")
    # before the first placement the length is unknown: a position has at
    # most one byte in each of the six rounds
    cap = NROUNDS * n if total is None else total
    stream = torch.empty(cap, dtype=torch.uint8, device=dev)
    # the step offsets and the stream's length, then the look-back's status
    # words and its ticket: one allocation, zeroed
    scratch = torch.zeros(2 * (T + 1), dtype=torch.int64, device=dev)
    offsets, status = scratch[:T + 1], scratch[T + 1:]
    fn = build.function("place", _ARGTYPES)
    build.check("place", fn(
        build.ptr(packed), build.ptr(nb), build.ptr(excw), n, T, S,
        build.ptr(stream), cap, build.ptr(offsets), build.ptr(status),
        build.current_stream(dev)))
    launches += 1
    got = int(offsets[T].item())
    if total is not None and got != total:
        raise ValueError(f"place: the words hold {got} bytes, not the "
                         f"{total} of the section plan")
    return stream[:got], offsets[:T], got
