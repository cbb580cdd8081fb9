"""Process-level runtime knobs (counterpart of ans_tpu/runtime.py).

`enable_compilation_cache` names the directory the port's compiled code
is kept in: the CUDA kernels (csrc/build.py) and the host library
(native/build.py), each named there by a hash of its sources and flags,
so a second run finds them built.  ans_tpu's `force_cpu` has no
counterpart: every entry point of the port takes its device.
"""

from __future__ import annotations

import os
from pathlib import Path

from .csrc import build as _kernel_build
from .native import build as _host_build

DEFAULT_CACHE = Path(__file__).resolve().parent / "_build"


def enable_compilation_cache(path: str | None = None) -> Path:
    """Build and look up the kernels and the host library in `path`
    (default: ans_tpu_torch/_build); returns the directory.  Libraries
    already loaded by this process stay loaded."""
    path = Path(os.path.abspath(path)) if path else DEFAULT_CACHE
    path.mkdir(parents=True, exist_ok=True)
    _kernel_build.BUILD_DIR = _host_build.BUILD_DIR = path
    return path
