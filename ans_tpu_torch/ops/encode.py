"""K1, the encode scan (csrc/encode_scan.cu), and K6, the grouped encode
scan (csrc/encode_scan_grouped.cu), and their wrappers.

Replace ans_tpu/ops/pallas_encode.py `encode_scan` (value-indexed tables)
and `encode_scan_grouped` (the frequency-grouped layout).

Each kernel scans a batch of D streams in one launch (`encode_scan_batch`,
`encode_scan_grouped_batch`), each stream under its own table (a
model_batch.ModelBatch of D tables: the blocks of a pseudo-adaptive
container) or all under one (a table: the sections of a blocked
container, every offset of the batch 0); the one-stream wrappers are the
batch of one."""

from __future__ import annotations

import ctypes as ct

import torch

from ..csrc import build
from . import model_batch
from .lane_codec import (batch_of_one, encode_scan_batch_plain,
                         encode_scan_grouped_batch_plain,
                         encode_scan_grouped_plain, encode_scan_plain)
from .tables import EncDevice, GroupedEncDevice

# launches of the CUDA kernels K1 and K6, one a batch (never counts a plain
# version)
launches = 0
grouped_launches = 0

_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_int,
             ct.c_void_p, ct.c_int, ct.c_int, ct.c_int, ct.c_void_p,
             ct.c_void_p, ct.c_void_p, ct.c_void_p]


def _check(name: str, syms: torch.Tensor, dims: int) -> None:
    if syms.dim() != dims or syms.dtype != torch.int32:
        shape = "(T, S)" if dims == 2 else "(D, T, S)"
        raise ValueError(f"{name}: syms must be a {shape} int32 tensor")


def _check_batch(name: str, syms: torch.Tensor, n: torch.Tensor, table):
    """The batch's models (model_batch.of(table)), after checking the
    inputs' shapes."""
    _check(name, syms, 3)
    if n.shape != (syms.shape[0],) or n.dtype != torch.int64:
        raise ValueError(f"{name}: n must be a ({syms.shape[0]},) int64 "
                         "tensor")
    batch = model_batch.of(table)
    batch.check(name, syms.shape[0])
    return batch


def _outputs(syms: torch.Tensor, dev):
    """packed shaped as syms, states (S,) or (D, S), and the error flag."""
    S = syms.shape[-1]
    return (torch.empty(syms.shape, dtype=torch.int32, device=dev),
            torch.empty(syms.shape[:-2] + (S,), dtype=torch.int32,
                        device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def _batch_dims(syms: torch.Tensor):
    """(D, T, S) of a (T, S) stream (D = 1) or a (D, T, S) batch."""
    T, S = syms.shape[-2:]
    return (1 if syms.dim() == 2 else syms.shape[0]), T, S


def encode_scan(syms: torch.Tensor, n: int, table: EncDevice):
    """Reverse rANS scan of the (T, S) i32 staged symbols.

    Returns (packed (T, S) i32 words r0|r1<<8|r2<<16|rc<<24, final
    states (S,) i32).  CPU tensors run the plain version
    (lane_codec.encode_scan_plain); CUDA tensors launch the kernel, as
    encode_scan_batch on a batch of one."""
    _check("encode_scan", syms, 2)
    if syms.device.type == "cpu" and table.words.device.type == "cpu":
        return encode_scan_plain(syms, n, table)
    return _scan(syms, batch_of_one(syms.device, int(n)),
                 model_batch.shared(table))


def encode_scan_batch(syms: torch.Tensor, n: torch.Tensor, table):
    """Reverse rANS scans of D streams: syms (D, T, S) i32 staged symbols,
    n (D,) i64 the positions of each stream (on syms' device), table an
    EncDevice the streams share or a ModelBatch of one a stream.  Returns
    (packed (D, T, S) i32, states (D, S) i32).  CPU tensors run the plain
    version (lane_codec.encode_scan_batch_plain); CUDA tensors launch the
    kernel once for the batch."""
    batch = _check_batch("encode_scan", syms, n, table)
    if all(t.device.type == "cpu" for t in (syms, n,
                                            *batch.device_tensors())):
        return encode_scan_batch_plain(syms, n, batch)
    return _scan(syms, n, batch)


def _scan(syms: torch.Tensor, n: torch.Tensor, batch):
    global launches
    words = batch.tensors["words"]
    dev = build.require_cuda("encode_scan", syms, n, words, batch.meta)
    D, T, S = _batch_dims(syms)
    packed, states, err = _outputs(syms, dev)
    fn = build.function("encode_scan", _ARGTYPES)
    build.check("encode_scan", fn(
        build.ptr(syms), build.ptr(words), build.ptr(batch.meta),
        batch.stride, batch.largest("words_len"), build.ptr(n), D, T, S,
        build.ptr(packed), build.ptr(states), build.ptr(err),
        build.current_stream(dev)))
    launches += 1
    if err.item():
        raise ValueError("encode_scan: a symbol lies outside the table")
    return packed, states


_GROUPED_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
                     ct.c_void_p, ct.c_int, ct.c_int, ct.c_int, ct.c_void_p,
                     ct.c_int, ct.c_int, ct.c_int, ct.c_void_p, ct.c_void_p,
                     ct.c_void_p, ct.c_void_p]


def _grouped_tensors(table: GroupedEncDevice, *inputs):
    """The tensors a grouped scan reads: its inputs and the tables."""
    tensors = [*inputs, table.groups, table.bases]
    if table.rank_of is not None:
        tensors.append(table.rank_of)
    return tensors


def encode_scan_grouped(syms: torch.Tensor, n: int, table: GroupedEncDevice):
    """Reverse rANS scan of the (T, S) i32 staged ranks, or symbol ids
    when table.rank_of is set, under the frequency-grouped layout.

    Returns (packed, states) as encode_scan does; raises ValueError when
    a symbol or a rank lies outside the tables.  CPU tensors run the plain
    version (lane_codec.encode_scan_grouped_plain); CUDA tensors launch
    the kernel, as encode_scan_grouped_batch on a batch of one."""
    _check("encode_scan_grouped", syms, 2)
    if all(t.device.type == "cpu" for t in _grouped_tensors(table, syms)):
        return encode_scan_grouped_plain(syms, n, table)
    return _scan_grouped(syms, batch_of_one(syms.device, int(n)),
                         model_batch.shared(table))


def encode_scan_grouped_batch(syms: torch.Tensor, n: torch.Tensor, table):
    """The grouped scans of D streams, arguments and result as
    encode_scan_batch (table a GroupedEncDevice or a ModelBatch of them);
    raises ValueError when a symbol or a rank lies outside the tables.  CPU
    tensors run the plain version
    (lane_codec.encode_scan_grouped_batch_plain); CUDA tensors launch the
    kernel once for the batch."""
    batch = _check_batch("encode_scan_grouped", syms, n, table)
    if all(t.device.type == "cpu" for t in (syms, n,
                                            *batch.device_tensors())):
        return encode_scan_grouped_batch_plain(syms, n, batch)
    return _scan_grouped(syms, n, batch)


def _scan_grouped(syms: torch.Tensor, n: torch.Tensor, batch):
    global grouped_launches
    dev = build.require_cuda("encode_scan_grouped", syms, n,
                             *batch.device_tensors())
    D, T, S = _batch_dims(syms)
    packed, states, err = _outputs(syms, dev)
    rank_of = batch.tensors["rank_of"]
    fn = build.function("encode_scan_grouped", _GROUPED_ARGTYPES)
    build.check("encode_scan_grouped", fn(
        build.ptr(syms), build.ptr(batch.tensors["groups"]),
        build.ptr(batch.tensors["bases"]),
        None if rank_of is None else build.ptr(rank_of),
        build.ptr(batch.meta), batch.stride, batch.largest("groups_len"),
        batch.largest("depth"), build.ptr(n), D, T, S, build.ptr(packed),
        build.ptr(states), build.ptr(err), build.current_stream(dev)))
    grouped_launches += 1
    if err.item():
        raise ValueError("encode_scan_grouped: a symbol or rank lies "
                         "outside the table")
    return packed, states
