"""Device tracing hooks on torch.profiler (counterpart of
ans_tpu/utils/profiling.py, which wraps jax.profiler): a trace of the host
and, where there is one, the CUDA device around a region, written as a
Chrome trace (chrome://tracing, Perfetto)."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the region (CPU activity, and CUDA activity when a card is
    present) and write its Chrome trace to `logdir`/trace.json; yields the
    torch.profiler.profile object."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A labelled range in the trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
