"""Dataset file I/O, same formats as the reference.

reference: include/util.hpp:142-248 — `.u32` is raw little-endian uint32;
`.txt` is one unsigned integer per line.

A copy of ans_tpu/utils/io.py.
"""

from __future__ import annotations

import os

import numpy as np


def read_file_u32(path: str) -> np.ndarray:
    return np.fromfile(path, dtype="<u4")


def read_file_text(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.uint32, ndmin=1)


def write_file_u32(path: str, values) -> None:
    np.ascontiguousarray(values, dtype="<u4").tofile(path)


def write_file_text(path: str, values) -> None:
    with open(path, "w") as f:
        for v in np.asarray(values).tolist():
            f.write(f"{v}\n")


def read_input(path: str) -> np.ndarray:
    """Dispatch on extension like the drivers (util.hpp:160-192)."""
    if path.endswith(".txt"):
        return read_file_text(path)
    return read_file_u32(path)


def collect_inputs(path: str, text: bool = False):
    """Directory scan + extension filter (table_efficiency.cpp:142-155).
    Returns sorted list of file paths; a plain file is returned as-is."""
    if os.path.isfile(path):
        return [path]
    ext = ".txt" if text else ".u32"
    return sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(ext))
