"""K1, the encode scan (csrc/encode_scan.cu), and its wrapper.

Replaces ans_tpu/ops/pallas_encode.py `encode_scan` (value-indexed
tables; the grouped scan K6 is not ported yet)."""

from __future__ import annotations

import ctypes as ct

import torch

from ..csrc import build
from .lane_codec import encode_scan_plain
from .tables import EncDevice

# launches of the CUDA kernel (never counts the plain version)
launches = 0

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
