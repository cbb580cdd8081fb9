"""The port's host library: native/ans_native.cpp (a copy of ans_tpu's
native backend), built by g++ at first use (build.py) and bound with
ctypes (binding.py).

The host modules reach it through a module global `_native`, which is
`deferred` (the library, built and loaded at its first use); the
pure-Python body beside each call is its plain version and runs only when
a caller sets that global to None.  Without g++ the first use raises:
there is no quiet fall-back.
"""

from __future__ import annotations

import numpy as np

from . import build
from .binding import NativeLib

_lib: NativeLib | None = None


def lib() -> NativeLib:
    """The host library, built and loaded at the first call."""
    global _lib
    if _lib is None:
        _lib = NativeLib.load(build.build())
    return _lib


class _Deferred:
    """Stands for the library in the modules' `_native` globals, so that
    importing a module builds nothing: the first attribute read builds
    and loads it."""

    def __getattr__(self, name):
        return getattr(lib(), name)


deferred = _Deferred()


def byte_histogram(arr, native=deferred):
    """256-bin u64 histogram of a uint8 array (`native`: the library, or
    None for the plain version)."""
    if native is not None and len(arr):
        return native.hist_u8(arr)
    return np.bincount(arr, minlength=256).astype(np.uint64)
