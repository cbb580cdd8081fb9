"""K2, the placement (csrc/place.cu), and its wrapper.

Replaces ans_tpu/ops/pallas_place.py `place` + `sections_to_stream`: the
stream comes out flat, since sections are contiguous slices of it, and the
kernel computes the stream offset of every step itself, in the same pass,
as the TPU kernel carries its byte cursor from one grid step to the next.

One launch places a batch of D streams that share one lane count and step
count (`place_batch`: the sections of a blocked container) as one chain,
their bytes one after the other in one buffer; `place` is the batch of
one."""

from __future__ import annotations

import ctypes as ct

import numpy as np
import torch

from ..csrc import build
from .lane_codec import NROUNDS, batch_of_one, place_batch_plain, place_plain

# launches of the CUDA kernel, one a batch (never counts the plain version)
launches = 0

MAX_LANES = 1 << 14  # the kernel stages 6 S bytes of a step in shared memory

_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int,
             ct.c_int, ct.c_int, ct.c_void_p, ct.c_int64, ct.c_void_p,
             ct.c_void_p, ct.c_void_p]


def place(packed: torch.Tensor, nb: torch.Tensor, excw: torch.Tensor,
          n: int, total: int | None = None):
    """Bytes of the encode scan into the fmt-2 stream.

    packed/nb/excw: (T, S) i32 (scan words, exception-byte counts, the
    values' three low bytes).  Returns (stream (total,) u8, step_base (T,)
    i64: the stream offset of each step, total: the stream's length).
    `total`, when given (a prepared encoder's section plan), must be what
    the words add up to, else ValueError.  CPU tensors run the plain
    version (lane_codec.place_plain); CUDA tensors launch the kernel, as
    place_batch on a batch of one."""
    T, S = packed.shape
    _check_words((T, S), packed, nb, excw)
    if all(t.device.type == "cpu" for t in (packed, nb, excw)):
        return place_plain(packed, nb, excw, n, total)
    stream, offsets, ends = place_batch(
        packed[None], nb[None], excw[None],
        batch_of_one(packed.device, int(n)),
        None if total is None else [total])
    return stream, offsets[0, :T], int(ends[0])


def place_batch(packed: torch.Tensor, nb: torch.Tensor, excw: torch.Tensor,
                n: torch.Tensor, ends=None):
    """The placements of D streams as one stream buffer.

    packed/nb/excw: (D, T, S) i32; n: (D,) i64 the positions of each stream
    (on the tensors' device).  Returns (stream (ends[-1],) u8, the D streams
    one after the other; offsets (D, T + 1) i64 on the device: the offset
    in `stream` of each step of each stream, then that stream's end; ends:
    (D,) i64 NumPy, the streams' ends).  `ends`, when given (a prepared
    encoder's plan), must be what the words add up to, else ValueError.
    One sync reads the ends.  `offsets` is a view (the kernel writes it
    step-major).  CPU tensors run the plain version (lane_codec.place_plain,
    stream by stream); CUDA tensors launch the kernel once for the batch."""
    D, T, S = packed.shape
    _check_words((D, T, S), packed, nb, excw)
    if n.shape != (D,) or n.dtype != torch.int64:
        raise ValueError(f"place: n must be a ({D},) int64 tensor")
    if all(t.device.type == "cpu" for t in (packed, nb, excw, n)):
        stream, offsets = place_batch_plain(packed, nb, excw, n)
    else:
        # without a plan the length is unknown: a position has at most
        # one byte in each of the six rounds
        cap = NROUNDS * D * T * S if ends is None else int(ends[-1])
        stream, offsets = _place(packed, nb, excw, n, cap)
    got = offsets[:, T].cpu().numpy()  # one row of the buffer: one copy
    if ends is not None and not np.array_equal(got, ends):
        raise ValueError(f"place: the words hold {_lens(got)} bytes, not "
                         f"the {_lens(ends)} of the section plan")
    return stream[:int(got[-1])], offsets, got


def _check_words(shape, packed, nb, excw) -> None:
    for name, t in (("packed", packed), ("nb", nb), ("excw", excw)):
        if t.shape != shape or t.dtype != torch.int32:
            raise ValueError(f"place: {name} must be a "
                             f"{tuple(shape)} int32 tensor")


def _place(packed, nb, excw, n: torch.Tensor, cap: int):
    """The launch for a (D, T, S) batch: (stream (cap,) u8, offsets
    (D, T + 1) i64, a view of the step-major buffer the kernel writes)."""
    global launches
    dev = build.require_cuda("place", packed, nb, excw, n)
    D, T, S = packed.shape
    if S > MAX_LANES:
        raise ValueError(f"place: at most {MAX_LANES} lanes, got {S}")
    stream = torch.empty(cap, dtype=torch.uint8, device=dev)
    # the step offsets, (T + 1, D) so that the streams' ends lie side by
    # side, then the look-back's status words (a chunk holds a step at
    # least) and its ticket: one allocation, zeroed
    scratch = torch.zeros(2 * D * (T + 1), dtype=torch.int64, device=dev)
    fn = build.function("place", _ARGTYPES)
    build.check("place", fn(
        build.ptr(packed), build.ptr(nb), build.ptr(excw), build.ptr(n), D,
        T, S, build.ptr(stream), cap, build.ptr(scratch),
        ct.c_void_p(scratch.data_ptr() + 8 * D * (T + 1)),
        build.current_stream(dev)))
    launches += 1
    return stream, scratch.as_strided((D, T + 1), (1, D))


def _lens(ends):
    """The lengths of streams that end at `ends`, one after the other."""
    e = np.asarray(ends, dtype=np.int64)
    lens = np.diff(e, prepend=0)
    return int(lens[0]) if len(lens) == 1 else lens.tolist()
