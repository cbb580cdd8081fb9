"""K3, the pivot-search lockstep decode (csrc/decode_search.cu), K4, the
direct lockstep decode over per-slot tables (csrc/decode_direct.cu), and
K5, the grouped lockstep decode (csrc/decode_grouped.cu), and their
wrappers.

Replace ans_tpu/ops/pallas_decode.py `stage_search` + `_call_search`,
`stage` + `_call` and `stage_grouped` + `_call_grouped`.

The three have two instances each (csrc/lockstep.cuh): "ring" stages
the stream in a shared-memory ring ahead of the cursor, "global" reads it
from device memory.  The wrapper takes "ring" wherever the ring fits the
block's shared memory beside the tables (`choose_instance`);
`instance_launches` counts each.

Each kernel decodes a batch of D streams in one launch, one block a
stream (`decode_search_batch`, `decode_direct_batch`,
`decode_grouped_batch`), each stream under its own frame (a
model_batch.ModelBatch of D tables: the blocks of a pseudo-adaptive
container) or all under one (a table: the sections of a blocked
container, every offset of the batch 0); the one-stream wrappers are the
batch of one.  The instance is one choice for the batch, taken by its
largest frame, and its error word is one for the batch: one sync a
launch."""

from __future__ import annotations

import ctypes as ct

import torch

from ..csrc import build
from . import model_batch
from .lane_codec import (batch_of_one, decode_direct_batch_plain,
                         decode_grouped_batch_plain,
                         decode_search_batch_plain)
from .tables import (DIRECT_TABLE_BYTES, DirectDevice, GroupedDecDevice,
                     SearchDevice)

# launches of the CUDA kernels K3, K4 and K5, one a batch (never counts a
# plain version)
launches = 0
direct_launches = 0
grouped_launches = 0

# launches by instance (each also counts in `launches` / `direct_launches`
# / `grouped_launches`)
instance_launches = {"decode_search": {"ring": 0, "global": 0},
                     "decode_direct": {"ring": 0, "global": 0},
                     "decode_grouped": {"ring": 0, "global": 0}}

# the kernels keep LPT = S/1024 lane states per thread in registers and
# are compiled for LPT <= 16
MAX_LANES = 1 << 14

INSTANCES = ("ring", "global")

# the kernels keep 32-bit stream offsets (the wrappers hold the whole
# buffer of a batch to it)
MAX_STREAM_BYTES = (1 << 31) - 1


def ring_bytes(S: int, rounds: int) -> int:
    """Size of the shared-memory ring that stages the stream for S lanes
    reading in `rounds` byte rounds a step: a step consumes at most
    S * rounds bytes and the ring is refilled one step ahead, so it holds
    two steps and one 16-byte granule, rounded up to a power of two."""
    need = max(2 * S * rounds + 16, 1024)
    return 1 << (need - 1).bit_length()


def choose_instance(name: str, table_bytes: int, S: int, rounds: int,
                    instance: str | None = None) -> tuple[str, int]:
    """(instance, ring bytes) for a kernel whose tables take table_bytes
    of shared memory: "ring" when the ring fits beside them, else
    "global" (ring bytes 0).  Forcing "ring" where it does not fit
    raises ValueError."""
    if instance not in (None, *INSTANCES):
        raise ValueError(f"{name}: unknown instance {instance!r}")
    ring = ring_bytes(S, rounds)
    fits = table_bytes + ring <= DIRECT_TABLE_BYTES
    if instance == "ring" and not fits:
        raise ValueError(
            f"{name}: a ring of {ring} bytes does not fit shared memory "
            f"beside {table_bytes} bytes of tables "
            f"({DIRECT_TABLE_BYTES} in all)")
    if instance == "global" or not fits:
        return "global", 0
    return "ring", ring


_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
             ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_int,
             ct.c_int, ct.c_int, ct.c_int, ct.c_void_p, ct.c_int, ct.c_int,
             ct.c_int, ct.c_int, ct.c_void_p, ct.c_void_p, ct.c_void_p]


def decode_search(stream: torch.Tensor, states: torch.Tensor,
                  table: SearchDevice, n: int, T: int,
                  instance: str | None = None) -> torch.Tensor:
    """Decode T lockstep steps of S = len(states) lanes.

    stream: (L,) u8 concatenated payload; states: (S,) i32 final encoder
    states.  Returns (T, S) i32 bit patterns of the u32 values (only the
    first n positions are meaningful).  Raises ValueError when a read
    would pass the end of the stream.  The stream may start at any byte
    address.  decode_search_batch on a batch of one."""
    _check_inputs("decode_search", stream, states)
    return decode_search_batch(stream, *_one(stream, states, n), table, T,
                               instance)[0]


def decode_search_batch(stream: torch.Tensor, stream_off: torch.Tensor,
                        states: torch.Tensor, n: torch.Tensor, table, T: int,
                        instance: str | None = None) -> torch.Tensor:
    """Decode D streams of T lockstep steps: stream b is
    stream[stream_off[b]:stream_off[b + 1]] (stream_off (D + 1,) i64),
    states (D, S) i32, n (D,) i64 its positions, table the SearchDevice the
    streams share or a ModelBatch of one a stream.  Returns (D, T, S) i32
    (only the first n[b] positions of stream b are meaningful).  Raises
    ValueError when a read would pass the end of its stream.  CPU tensors
    run the plain version (lane_codec.decode_search_batch_plain); CUDA
    tensors launch the kernel once for the batch, in the instance
    choose_instance picks for its largest frame (`instance` forces
    one)."""
    global launches
    batch = _check_batch("decode_search", stream, stream_off, states, n,
                         table)
    tensors = (stream, stream_off, states, n, *batch.device_tensors())
    if all(t.device.type == "cpu" for t in tensors):
        return decode_search_batch_plain(stream, stream_off, states, n,
                                  batch, T)
    S = _lanes("decode_search", states, stream)
    depth, sigma = batch.largest("depth"), batch.largest("sigma")
    NR, NE = batch.largest("NR"), batch.largest("NE")
    which, ring, _ = launch_plan("decode_search", batch, S, instance)
    dev = build.require_cuda("decode_search", *tensors)
    D = states.shape[0]
    out = torch.empty((D, T, S), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    t = batch.tensors
    fn = build.function("decode_search", _ARGTYPES)
    build.check("decode_search", fn(
        build.ptr(stream), build.ptr(stream_off), build.ptr(states),
        build.ptr(t["bases"]), build.ptr(t["high"]), build.ptr(t["nb"]),
        build.ptr(batch.meta), batch.stride, depth, sigma, NR, NE,
        build.ptr(n), D, T, S, ring, build.ptr(out), build.ptr(err),
        build.current_stream(dev)))
    launches += 1
    instance_launches["decode_search"][which] += 1
    _raise_on(err)
    return out


_DIRECT_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
                    ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_int, ct.c_int,
                    ct.c_int, ct.c_void_p, ct.c_int, ct.c_int, ct.c_int,
                    ct.c_int, ct.c_void_p, ct.c_void_p, ct.c_void_p]


def decode_direct(stream: torch.Tensor, states: torch.Tensor,
                  table: DirectDevice, n: int, T: int,
                  instance: str | None = None) -> torch.Tensor:
    """Decode T lockstep steps through the per-slot table of the frame
    (either slot layout); arguments, result and errors as decode_search.
    Raises ValueError when the tables do not fit the shared memory of one
    block.  decode_direct_batch on a batch of one."""
    _check_inputs("decode_direct", stream, states)
    return decode_direct_batch(stream, *_one(stream, states, n), table, T,
                               instance)[0]


def decode_direct_batch(stream: torch.Tensor, stream_off: torch.Tensor,
                        states: torch.Tensor, n: torch.Tensor, table, T: int,
                        instance: str | None = None) -> torch.Tensor:
    """Decode D streams through the per-slot tables of their frames (table
    a DirectDevice or a ModelBatch of them); arguments, result and errors
    as decode_search_batch.  Raises ValueError when a frame's tables do not
    fit the shared memory of one block.  CPU tensors run the plain version
    (lane_codec.decode_direct_batch_plain); CUDA tensors launch the kernel
    once for the batch."""
    global direct_launches
    batch = _check_batch("decode_direct", stream, stream_off, states, n,
                         table)
    smem = _direct_bytes(batch)
    if smem > DIRECT_TABLE_BYTES:
        raise ValueError(
            f"decode_direct: the frame's tables take {smem} bytes of "
            f"shared memory; a block has {DIRECT_TABLE_BYTES}")
    tensors = (stream, stream_off, states, n, *batch.device_tensors())
    if all(t.device.type == "cpu" for t in tensors):
        return decode_direct_batch_plain(stream, stream_off, states, n,
                                  batch, T)
    S = _lanes("decode_direct", states, stream)
    NR, NE = batch.largest("NR"), batch.largest("NE")
    which, ring, _ = launch_plan("decode_direct", batch, S, instance)
    dev = build.require_cuda("decode_direct", *tensors)
    D = states.shape[0]
    out = torch.empty((D, T, S), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = build.function("decode_direct", _DIRECT_ARGTYPES)
    build.check("decode_direct", fn(
        build.ptr(stream), build.ptr(stream_off), build.ptr(states),
        build.ptr(batch.tensors["rows"]), build.ptr(batch.tensors["slot_sym"]),
        build.ptr(batch.meta), batch.stride, smem, NR, NE, build.ptr(n), D,
        T, S, ring, build.ptr(out), build.ptr(err),
        build.current_stream(dev)))
    direct_launches += 1
    instance_launches["decode_direct"][which] += 1
    _raise_on(err)
    return out


_GROUPED_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
                     ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
                     ct.c_void_p, ct.c_int, ct.c_int, ct.c_int, ct.c_int,
                     ct.c_void_p, ct.c_int, ct.c_int, ct.c_int, ct.c_int,
                     ct.c_int, ct.c_void_p, ct.c_void_p, ct.c_void_p]


def grouped_shared_tables(table) -> tuple[bool, int]:
    """(whether K5 stages the per-rank table and nb in shared memory, the
    bytes of shared memory its tables then take) for a GroupedDecDevice or
    a ModelBatch of them: the group tables always, the per-rank tables
    when every frame's fit the block, each frame laid out as the kernel
    lays it out (nb's bytes in every frame when one has exception bytes),
    the largest frame's bytes."""
    batch = model_batch.of(table)

    def plan():
        NG = batch.column("groups_len")
        small = (16 * NG + 4 * (NG + (1 << batch.column("levels")))
                 + 2 * batch.column("buckets_len"))
        nes = batch.largest("NE") > 0
        both = small + 4 * batch.column("table_len") + (
            batch.column("sigma") if nes else 0)
        fits = int(both.max()) <= DIRECT_TABLE_BYTES
        return fits, int((both if fits else small).max())

    return batch.remember("grouped_shared_tables", plan)


def decode_grouped(stream: torch.Tensor, states: torch.Tensor,
                   table: GroupedDecDevice, n: int, T: int,
                   instance: str | None = None) -> torch.Tensor:
    """Decode T lockstep steps of a frequency-grouped frame; arguments,
    result and errors as decode_search.  The per-rank table goes to
    shared memory when it fits (grouped_shared_tables), and the stream's
    ring when it fits beside what is there.  decode_grouped_batch on a
    batch of one."""
    _check_inputs("decode_grouped", stream, states)
    return decode_grouped_batch(stream, *_one(stream, states, n), table, T,
                                instance)[0]


def decode_grouped_batch(stream: torch.Tensor, stream_off: torch.Tensor,
                         states: torch.Tensor, n: torch.Tensor, table,
                         T: int, instance: str | None = None) -> torch.Tensor:
    """Decode D streams of frequency-grouped frames (table a
    GroupedDecDevice the streams share or a ModelBatch of one a stream);
    arguments, result and errors as decode_search_batch.  CPU tensors run
    the plain version (lane_codec.decode_grouped_batch_plain); CUDA tensors
    launch the kernel once for the batch."""
    global grouped_launches
    batch = _check_batch("decode_grouped", stream, stream_off, states, n,
                         table)
    tensors = (stream, stream_off, states, n, *batch.device_tensors())
    if all(t.device.type == "cpu" for t in tensors):
        return decode_grouped_batch_plain(stream, stream_off, states, n,
                                  batch, T)
    S = _lanes("decode_grouped", states, stream)
    NR, NE = batch.largest("NR"), batch.largest("NE")
    which, ring, (smem_table, smem) = launch_plan("decode_grouped", batch, S,
                                                  instance)
    dev = build.require_cuda("decode_grouped", *tensors)
    D = states.shape[0]
    out = torch.empty((D, T, S), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    t = batch.tensors
    fn = build.function("decode_grouped", _GROUPED_ARGTYPES)
    build.check("decode_grouped", fn(
        build.ptr(stream), build.ptr(stream_off), build.ptr(states),
        build.ptr(t["groups"]), build.ptr(t["bases"]),
        build.ptr(t["buckets"]),
        build.ptr(t["table"]) if t["table"].numel() else None,
        build.ptr(t["nb"]) if NE else None, build.ptr(batch.meta),
        batch.stride, smem, NR, NE, build.ptr(n), D, T, S, ring,
        int(smem_table), build.ptr(out), build.ptr(err),
        build.current_stream(dev)))
    grouped_launches += 1
    instance_launches["decode_grouped"][which] += 1
    _raise_on(err)
    return out


def _direct_bytes(batch) -> int:
    """Shared memory K4's tables take: the largest frame's u16 per slot
    and 16-byte row per live symbol."""
    return batch.remember("direct_bytes", lambda: int(
        (2 * batch.column("frame_size") + 16 * batch.column("sigma")).max()))


def launch_plan(name: str, table, S: int, instance: str | None = None):
    """(instance, ring bytes, what else the launch fixes) of decode kernel
    `name` ("decode_search", "decode_direct" or "decode_grouped") for a
    table or a ModelBatch at S lanes, as its wrapper launches it: the
    instance by choose_instance on the largest frame's tables and rounds;
    for K5 also (whether the per-rank tables go to shared memory, their
    bytes), else None."""
    batch = model_batch.of(table)

    def plan():
        rounds = batch.largest("NR") + batch.largest("NE")
        extra = None
        if name == "decode_search":
            smem = 4 * ((1 << batch.largest("depth")) + 1
                        + 2 * batch.largest("sigma"))
        elif name == "decode_direct":
            smem = _direct_bytes(batch)
        else:
            extra = grouped_shared_tables(batch)
            smem = extra[1]
        return (*choose_instance(name, smem, S, rounds, instance), extra)

    return batch.remember(("launch_plan", name, S, instance), plan)


def _check_inputs(name: str, stream: torch.Tensor,
                  states: torch.Tensor) -> None:
    if stream.dim() != 1 or stream.dtype != torch.uint8:
        raise ValueError(f"{name}: stream must be a 1-d uint8 tensor")
    if states.dim() != 1 or states.dtype != torch.int32:
        raise ValueError(f"{name}: states must be a 1-d int32 tensor")


def _one(stream: torch.Tensor, states: torch.Tensor, n: int):
    """(stream_off, states, n) of a batch of one, on the stream's
    device."""
    meta = batch_of_one(stream.device, 0, stream.numel(), int(n))
    return meta[:2], states[None], meta[2:]


def _check_batch(name: str, stream: torch.Tensor, stream_off: torch.Tensor,
                 states: torch.Tensor, n: torch.Tensor, table):
    """The batch's models (model_batch.of(table)), after checking the
    inputs' shapes."""
    if stream.dim() != 1 or stream.dtype != torch.uint8:
        raise ValueError(f"{name}: stream must be a 1-d uint8 tensor")
    if states.dim() != 2 or states.dtype != torch.int32:
        raise ValueError(f"{name}: states must be a (D, S) int32 tensor")
    D = states.shape[0]
    if stream_off.shape != (D + 1,) or stream_off.dtype != torch.int64:
        raise ValueError(f"{name}: stream_off must be a ({D + 1},) int64 "
                         "tensor")
    if n.shape != (D,) or n.dtype != torch.int64:
        raise ValueError(f"{name}: n must be a ({D},) int64 tensor")
    batch = model_batch.of(table)
    batch.check(name, D)
    return batch


def _lanes(name: str, states: torch.Tensor, stream: torch.Tensor) -> int:
    """The lane count of a launch, after the checks that need no card:
    the kernels' limits on the stream's length and on S."""
    if stream.numel() > MAX_STREAM_BYTES:
        raise NotImplementedError(
            f"{name}: a stream of {stream.numel()} bytes; the kernel takes "
            f"at most {MAX_STREAM_BYTES}")
    S = states.shape[-1]
    if S > MAX_LANES:
        raise NotImplementedError(
            f"{name}: S = {S} lanes; the kernel takes at most {MAX_LANES}")
    return S


def _raise_on(err: torch.Tensor) -> None:
    if err.item():
        raise ValueError("corrupt lane stream: a read passes the end of "
                         "the stream")
