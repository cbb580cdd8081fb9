"""K1, the encode scan (csrc/encode_scan.cu), and K6, the grouped encode
scan (csrc/encode_scan_grouped.cu), and their wrappers.

Replace ans_tpu/ops/pallas_encode.py `encode_scan` (value-indexed tables)
and `encode_scan_grouped` (the frequency-grouped layout)."""

from __future__ import annotations

import ctypes as ct

import torch

from ..csrc import build
from .lane_codec import encode_scan_grouped_plain, encode_scan_plain
from .tables import EncDevice, GroupedEncDevice

# launches of the CUDA kernels K1 and K6 (never counts a plain version)
launches = 0
grouped_launches = 0

_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_int64, ct.c_int,
             ct.c_int, ct.c_int, ct.c_void_p, ct.c_void_p, ct.c_void_p,
             ct.c_void_p]


def encode_scan(syms: torch.Tensor, n: int, table: EncDevice):
    """Reverse rANS scan of the (T, S) i32 staged symbols.

    Returns (packed (T, S) i32 words r0|r1<<8|r2<<16|rc<<24, final
    states (S,) i32).  CPU tensors run the plain version
    (lane_codec.encode_scan_plain); CUDA tensors launch the kernel."""
    global launches
    if syms.dim() != 2 or syms.dtype != torch.int32:
        raise ValueError("encode_scan: syms must be a (T, S) int32 tensor")
    if syms.device.type == "cpu" and table.words.device.type == "cpu":
        return encode_scan_plain(syms, n, table)
    dev = build.require_cuda("encode_scan", syms, table.words)
    T, S = syms.shape
    packed = torch.empty((T, S), dtype=torch.int32, device=dev)
    states = torch.empty(S, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = build.function("encode_scan", _ARGTYPES)
    build.check("encode_scan", fn(
        build.ptr(syms), build.ptr(table.words), table.words.shape[0], n,
        T, S, table.log2m, build.ptr(packed), build.ptr(states),
        build.ptr(err), build.current_stream(dev)))
    launches += 1
    if err.item():
        raise ValueError("encode_scan: a symbol lies outside the table")
    return packed, states


_GROUPED_ARGTYPES = [ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
                     ct.c_int64, ct.c_int, ct.c_int, ct.c_int, ct.c_int64,
                     ct.c_int, ct.c_int, ct.c_int, ct.c_void_p, ct.c_void_p,
                     ct.c_void_p, ct.c_void_p]


def encode_scan_grouped(syms: torch.Tensor, n: int, table: GroupedEncDevice):
    """Reverse rANS scan of the (T, S) i32 staged ranks, or symbol ids
    when table.rank_of is set, under the frequency-grouped layout.

    Returns (packed, states) as encode_scan does; raises ValueError when
    a symbol or a rank lies outside the tables.  CPU tensors run the
    plain version (lane_codec.encode_scan_grouped_plain); CUDA tensors
    launch the kernel."""
    global grouped_launches
    if syms.dim() != 2 or syms.dtype != torch.int32:
        raise ValueError("encode_scan_grouped: syms must be a (T, S) int32 "
                         "tensor")
    tensors = [syms, table.groups, table.bases]
    if table.rank_of is not None:
        tensors.append(table.rank_of)
    if all(t.device.type == "cpu" for t in tensors):
        return encode_scan_grouped_plain(syms, n, table)
    dev = build.require_cuda("encode_scan_grouped", *tensors)
    T, S = syms.shape
    packed = torch.empty((T, S), dtype=torch.int32, device=dev)
    states = torch.empty(S, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    rank_of = table.rank_of
    fn = build.function("encode_scan_grouped", _GROUPED_ARGTYPES)
    build.check("encode_scan_grouped", fn(
        build.ptr(syms), build.ptr(table.groups), build.ptr(table.bases),
        None if rank_of is None else build.ptr(rank_of),
        0 if rank_of is None else rank_of.numel(), table.groups.shape[0],
        table.depth, table.sigma, n, T, S, table.log2m, build.ptr(packed),
        build.ptr(states), build.ptr(err), build.current_stream(dev)))
    grouped_launches += 1
    if err.item():
        raise ValueError("encode_scan_grouped: a symbol or rank lies "
                         "outside the table")
    return packed, states
