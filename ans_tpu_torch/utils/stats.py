"""Compression stats singleton (reference: include/stats.hpp:20-41).

The reference fills a global {prelude_bytes, encode_bytes, prelude_time_ns,
encode_time_ns} under #ifdef RECORD_STATS; here recording is a runtime
flag and codecs report through record_stats().

A copy of ans_tpu/utils/stats.py.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field


@dataclass
class CompStats:
    prelude_bytes: int = 0
    encode_bytes: int = 0
    prelude_time_ns: int = 0
    encode_time_ns: int = 0
    enabled: bool = False

    def reset(self):
        self.prelude_bytes = self.encode_bytes = 0
        self.prelude_time_ns = self.encode_time_ns = 0


comp_stats = CompStats()


def record_stats(prelude_bytes=0, encode_bytes=0, prelude_time_ns=0,
                 encode_time_ns=0):
    if comp_stats.enabled:
        comp_stats.prelude_bytes += prelude_bytes
        comp_stats.encode_bytes += encode_bytes
        comp_stats.prelude_time_ns += prelude_time_ns
        comp_stats.encode_time_ns += encode_time_ns


@contextlib.contextmanager
def recording():
    comp_stats.enabled = True
    comp_stats.reset()
    try:
        yield comp_stats
    finally:
        comp_stats.enabled = False
