"""The traced window: torch.profiler over the whole closed loop, with CUDA
activity alone, reduced to what the per-layer metrics and the breakdown
read.

  * busy_s: the union of the device intervals (kernels, copies, memsets)
    of the trace, so device work that overlaps counts once (the
    arithmetic of ans_tpu_torch/profile_idle.py); every device interval
    lies inside the window, which starts after the warm-up's synchronise
    and ends with its last request's;
  * window_s: the window's seconds on the host clock;
  * device_ops: device seconds by operation name, most first;
  * idle_gaps: the device's idle seconds between its first and its last
    interval, by the CUDA runtime or driver call the host was in at the
    middle of each gap, else host work between those calls, most first.

The profiler records no host operations (no CPU activity), so that what
it adds to each call stays small against a sub-millisecond request; the
CUDA calls it does record label the gaps.
"""

from __future__ import annotations

import bisect
import json
import tempfile
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
BETWEEN = "host work between CUDA calls"
TOP = 10


def profiled(fn, read: bool = True):
    """(fn(), the summary of its trace, or None when the trace holds no
    device work, there is no CUDA device to trace, or `read` is false: a
    rank traced only so that it runs as the rank that is read does).  fn
    returns a traffic.Window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        return fn(), None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
    if not read:
        return result, None
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return result, summarize(events, result.seconds)


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top(totals: dict) -> list:
    return [[name, us / 1e6] for name, us in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def summarize(events: list, window_s: float):
    ops = defaultdict(float)
    inside = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if b > a:
            inside.append((a, b))
            ops[e["name"][:120]] += b - a
    busy = _merged(inside)
    busy_us = sum(b - a for a, b in busy)
    if not busy_us:
        return None
    # the host's outermost CUDA calls, in time order
    host, reach = [], float("-inf")
    for e in sorted((e for e in events if e.get("cat") in HOST_CATS),
                    key=lambda e: (float(e["ts"]), -float(e.get("dur", 0)))):
        if float(e["ts"]) >= reach:
            host.append(e)
            reach = float(e["ts"]) + float(e.get("dur", 0))
    starts = [float(e["ts"]) for e in host]
    gaps = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = BETWEEN
        if i >= 0 and mid < starts[i] + float(host[i].get("dur", 0)):
            label = host[i]["name"][:120]
        gaps[label] += b - a
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "device_ops": _top(ops), "idle_gaps": _top(gaps)}
