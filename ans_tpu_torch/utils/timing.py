"""RAII-style stage timer (reference: include/util.hpp:73-89).

A copy of ans_tpu/utils/timing.py.
"""

from __future__ import annotations

import contextlib
import sys
import time


@contextlib.contextmanager
def timer(name: str, out=sys.stderr):
    t0 = time.perf_counter()
    out.write(f"START({name})\n")
    try:
        yield
    finally:
        out.write(f"STOP({name}) - {time.perf_counter() - t0:.3f} sec\n")
