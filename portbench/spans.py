"""The program's own spans and counters in a traced window, on the device
trace's clock.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>
        --spans <0|1>

From the root of a checkout, on a CUDA device: an operator's run of one
cell, as portbench/run.py sets it up and times it (the pool drawn from the
seed, the codec's `stage`, traffic.warm_up, the closed loop under a
CUDA-only torch.profiler), with ans_tpu_torch's span recorder
(`utils.stats.tracing()`) on over the set-up and the window when
`--spans 1`.  It checks no output (portbench/run.py does).  Its last line
of standard output is one JSON object: the window's requests and
latencies, the device's busy seconds and idle share, the idle gaps as
portbench/trace.py labels them, and with spans the gaps labelled by
program step, the clock check and the readings below.  Running it with
`--spans 0` and `--spans 1` on one seed gives the recorder's cost.

One clock: the recorder stamps spans on time.perf_counter_ns and its
Trace carries the offset to the epoch (`epoch_ns`); Kineto writes each
event's `ts` in us after the trace's `baseTimeNanoseconds`, on the epoch
clock.  So one offset maps every span onto the trace (`offset_us`).  The
check: the runtime calls that launch the program's kernels (kernels other
than PyTorch's own `at::` ones, matched by correlation id) must lie inside
the program's `launch` spans; `align` gives their share and the largest
miss.

The device's own times, as the trace puts them on the host clock, slip
against it (by up to milliseconds on an H100), so no gap is placed by
them: each idle gap is re-anchored on the host clock by the launch call
of the device op that ends it (correlation id), as the stretch of the
gap's length that ends where that call returns (`anchored_gaps`).  A gap
whose re-anchored start lies before the launch call of the op that
closed the stretch before it cannot be the host's (that op cannot end
before it is launched): it is "unanchored", as is a gap whose ops have no
launch call in the trace.  With under 99% of the launch calls inside
launch spans, or under 99% of the idle seconds anchored
(`anchored_share`), the gaps keep portbench/trace.py's labels.

Gap labels with spans (`summarize`): each re-anchored gap's seconds go
to the steps the host went through in it, each of its stretches to
"<span>: <call>" inside a CUDA call, the span being the innermost program
span open there ("harness" outside every span), and outside every CUDA
call to that span's name, else "harness".  (A gap is split, not named by
its middle: a write's ~180 us gap between two requests has the harness's
5 us synchronise at its middle.)  A span's name is its parent's and its
own ("decode_direct_batch.sync").  `busy_s`, `window_s` and `device_ops`
are portbench/trace.py's.

Readings (the recorder's; none is in BENCHMARK.json):
  * host_ms: the mean over the window's requests of the request span
    ("decode" or "encode", the prepared call) less its `sync` spans;
  * syncs: the "sync" counter over the window per completed request;
  * prepare_s: the set-up's outermost spans (`codec.encode`,
    `prepare_*`, `BlockCodec.*`) summed over the pool;
  * request_self_us: each span name's self time a request, in us;
  * setup_self_s: each set-up span's self time, summed over the pool, in
    s (where `prepare_s` goes: the model build, the tables, the staging,
    the priming encode).

It runs cells of one card; a cell over several (portbench/ranks.py) is
refused.

`run_cell`, `_profiled` and `main` repeat portbench/run.py's sequence and
portbench/trace.py's profiler; the rest is what those two would import
to report these readings.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import tempfile
import time
from collections import defaultdict
from contextlib import nullcontext
from pathlib import Path

from . import trace as kineto

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
HARNESS = "harness"
ALIGNED = 0.99   # the share of launch calls inside launch spans
ANCHORED = 0.99  # the share of the idle seconds in anchored gaps
REACH_US = 5.0   # the largest correction fitted to the epoch offset, and
                 # the slack of the anchoring's check
UNANCHORED = "unanchored"


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _intervals(trace, shift_ns: int, name=None):
    """(start, end, label) of the trace's closed spans in the chrome
    trace's us, once shifted by shift_ns, those named `name` or all."""
    return [((s.start_ns + shift_ns) / 1e3, (s.end_ns + shift_ns) / 1e3,
             trace.label(i))
            for i, s in enumerate(trace.spans)
            if s.end_ns and (name is None or s.name == name)]


def _correlation(e: dict):
    return e.get("args", {}).get("correlation")


def _program_launches(events: list) -> list:
    """(the runtime call, its kernel's start) of each launch of one of the
    program's kernels (not PyTorch's own `at::` ones)."""
    kernels = {_correlation(e): float(e["ts"]) for e in events
               if e.get("cat") == "kernel" and "at::" not in e["name"]}
    return [(e, kernels[c]) for e in events
            if e.get("cat") in kineto.HOST_CATS and e["name"] in LAUNCH_CALLS
            and (c := _correlation(e)) in kernels]


def launch_lag_us(events: list):
    """From the start of each launch call of a program kernel to the
    kernel's start on the device, in us: (least, median, most), or None.
    Both ends are the trace's own, the device's converted to the host's
    clock: a least under 0 says the conversion is off."""
    lags = sorted(start - float(e["ts"])
                  for e, start in _program_launches(events))
    if not lags:
        return None
    return lags[0], lags[len(lags) // 2], lags[-1]


def _best_shift(windows: list) -> float:
    """The middle of the first stretch that the most of the [lo, hi]
    windows cover (0 where none is given)."""
    ends = sorted([(lo, 0) for lo, _ in windows]
                  + [(hi, 1) for _, hi in windows])
    best, depth, at = 0, 0, 0.0
    for k, (x, kind) in enumerate(ends):
        depth += 1 if kind == 0 else -1
        if kind == 0 and depth > best:
            best, at = depth, (x + ends[k + 1][0]) / 2
    return at


def align(events: list, trace, base_ns: int) -> dict:
    """How the program's launch calls fall against its `launch` spans.
    The shift starts from the recorder's epoch offset, and one correction
    of at most REACH_US is fitted: the one that puts the most calls inside
    a span near them.  Returns the calls' count, the share inside a span,
    the largest miss in us (0 inside), the shift and the correction in
    us, and `shift_ns`."""
    shift_ns = trace.epoch_ns - base_ns
    spans = sorted(_intervals(trace, shift_ns, "launch"))
    starts = [a for a, _, _ in spans]
    calls = []
    for e, _ in _program_launches(events):
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        i = bisect.bisect_right(starts, a) - 1
        calls.append((a, b, spans[max(i - 1, 0):i + 2]))
    # span + d holds [a, b] for d in [b - end, a - start]
    windows = [(max(b - t, -REACH_US), min(a - s, REACH_US))
               for a, b, near in calls for s, t, _ in near
               if b - t <= a - s and b - t <= REACH_US
               and a - s >= -REACH_US]
    fitted = _best_shift(windows)
    inside, worst = 0, 0.0
    for a, b, near in calls:
        miss = min((max(s + fitted - a, 0.0) + max(b - t - fitted, 0.0)
                    for s, t, _ in near), default=float("inf"))
        inside += miss == 0
        worst = max(worst, miss)
    shift_ns += round(fitted * 1e3)
    return {"offset_us": shift_ns / 1e3, "fitted_us": fitted,
            "launch_calls": len(calls),
            "inside_share": inside / len(calls) if calls else 0.0,
            "largest_miss_us": worst, "shift_ns": shift_ns}


def _innermost(intervals: list):
    """(times, labels): from times[k] on, labels[k] is the innermost span
    open (None: none); the recorder's spans nest."""
    times, labels, stack = [], [], []

    def leave_until(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            times.append(end)
            labels.append(stack[-1][2] if stack else None)

    for a, b, label in sorted(intervals, key=lambda s: (s[0], -s[1])):
        leave_until(a)
        stack.append((a, b, label))
        times.append(a)
        labels.append(label)
    leave_until(float("inf"))
    return times, labels


def _device_runs(events: list) -> list:
    """The device's busy stretches in time order, as portbench/trace.py
    merges them: [start, end, the op that opens it, the op that ends
    it]."""
    ops = sorted((e for e in events if e.get("cat") in kineto.DEVICE_CATS
                  and float(e.get("dur", 0)) > 0),
                 key=lambda e: (float(e["ts"]),
                                float(e["ts"]) + float(e["dur"])))
    runs = []
    for e in ops:
        a = float(e["ts"])
        b = a + float(e["dur"])
        if runs and a <= runs[-1][1]:
            if b > runs[-1][1]:
                runs[-1][1], runs[-1][3] = b, e
        else:
            runs.append([a, b, e, e])
    return runs


def anchored_gaps(events: list) -> list:
    """The device's idle gaps on the host clock, in time order: (start,
    end, anchored), in us.  A gap ends where the launch call of the op
    that ends it returns, and starts the gap's length (on the device)
    before; it is anchored where that start lies no more than REACH_US
    before the launch call of the op that ended the stretch before it.
    An unanchored gap keeps its times from the device."""
    calls = {}
    for e in events:
        c = _correlation(e)
        if e.get("cat") in kineto.HOST_CATS and c is not None:
            a = float(e["ts"])
            if c not in calls or a < calls[c][0]:
                calls[c] = (a, a + float(e.get("dur", 0)))
    out = []
    runs = _device_runs(events)
    for (_, a, _, closer), (b, _, opener, _) in zip(runs, runs[1:]):
        call = calls.get(_correlation(opener))
        before = calls.get(_correlation(closer))
        if call is None or before is None:
            out.append((a, b, False))
            continue
        start = call[1] - (b - a)
        out.append((start, call[1], start + REACH_US >= before[0]))
    return out


def summarize(events: list, window_s: float, trace=None, base_ns=None):
    """(portbench/trace.py's summary, the clock check or None).  With spans
    whose launch calls lie in launch spans and whose gaps are anchored
    (each at 99% or more), the summary's `idle_gaps` are the idle
    seconds by program step, today's labels move to `cuda_call_gaps`, and
    `span_share` is the share of the idle seconds outside every CUDA call
    that lie inside a program span (the rest is `harness`).  Without
    spans, or with a check under 99%, the summary is portbench/trace.py's
    as it is."""
    summary = kineto.summarize(events, window_s)
    if summary is None or trace is None or base_ns is None:
        return summary, None
    check = align(events, trace, base_ns)
    gaps = anchored_gaps(events)
    idle = sum(b - a for a, b, _ in gaps)
    check["anchored_share"] = (sum(b - a for a, b, ok in gaps if ok) / idle
                               if idle else 1.0)
    if check["inside_share"] >= ALIGNED and \
            check["anchored_share"] >= ANCHORED:
        labelled, span_share = _label_gaps(events, trace, check["shift_ns"],
                                           gaps)
        summary.update(cuda_call_gaps=summary["idle_gaps"],
                       idle_gaps=labelled, span_share=span_share)
    return summary, check


def _host_steps(events: list, trace, shift_ns: int):
    """(times, labels, in_call): from times[k] on the host is at
    labels[k], "<span>: <call>" inside one of the outermost CUDA calls
    (in_call[k]), else "<span>"; the span is the innermost program span
    open, shifted by shift_ns ("harness" outside every span)."""
    span_t, span_l = _innermost(_intervals(trace, shift_ns))
    call_t, call_l, reach = [], [], float("-inf")
    for e in sorted((e for e in events if e.get("cat") in kineto.HOST_CATS),
                    key=lambda e: (float(e["ts"]), -float(e.get("dur", 0)))):
        a = float(e["ts"])
        if a >= reach:
            reach = a + float(e.get("dur", 0))
            call_t += [a, reach]
            call_l += [e["name"][:120], None]
    times = sorted(set(span_t) | set(call_t))
    labels, in_call = [], []
    for x in times:
        k = bisect.bisect_right(span_t, x) - 1
        step = (span_l[k] if k >= 0 else None) or HARNESS
        i = bisect.bisect_right(call_t, x) - 1
        call = call_l[i] if i >= 0 else None
        labels.append(f"{step}: {call}" if call else step)
        in_call.append(call is not None)
    return times, labels, in_call


def _label_gaps(events: list, trace, shift_ns: int, gaps: list):
    """(the idle seconds by program step, most first; span_share): each
    gap of `gaps` (as `anchored_gaps` gives them) split over the steps
    the host went through in it (`_host_steps`)."""
    times, labels, in_call = _host_steps(events, trace, shift_ns)
    named = defaultdict(float)
    between = spanned = 0.0
    for a, b, anchored in gaps:
        if not anchored:
            named[UNANCHORED] += b - a
            continue
        k = bisect.bisect_right(times, a) - 1
        x = a
        while x < b:
            y = min(b, times[k + 1]) if k + 1 < len(times) else b
            label = labels[k] if k >= 0 else HARNESS
            named[label] += y - x
            if k < 0 or not in_call[k]:
                between += y - x
                spanned += (y - x) * (label != HARNESS)
            x, k = y, k + 1
    return kineto._top(named), spanned / between if between else None


def window_requests(trace, lo_ns: int, hi_ns: int) -> list:
    """Indices of the request spans (a prepared call) that lie inside
    [lo_ns, hi_ns]."""
    return [i for i, s in enumerate(trace.spans)
            if s.parent is None and s.request is not None
            and lo_ns <= s.start_ns and 0 < s.end_ns <= hi_ns]


def host_ms(trace, requests: list):
    """The mean request span less its `sync` spans, in ms."""
    if not requests:
        return None
    ids = {trace.spans[i].request for i in requests}
    synced = sum(s.end_ns - s.start_ns for s in trace.spans
                 if s.name == "sync" and s.request in ids)
    total = sum(trace.spans[i].end_ns - trace.spans[i].start_ns
                for i in requests)
    return (total - synced) / len(requests) / 1e6


def request_self_us(trace, requests: list) -> dict:
    """Each span name's self time a request of `requests`, in us."""
    if not requests:
        return {}
    ids = {trace.spans[i].request for i in requests}
    own = trace.self_ns()
    out = defaultdict(float)
    for i, s in enumerate(trace.spans):
        if s.request in ids:
            out[trace.label(i)] += own[i] / 1e3 / len(requests)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def setup_self_s(trace) -> dict:
    """Each set-up span's (no request's) self time by name, summed, in s,
    most first."""
    own = trace.self_ns()
    out = defaultdict(float)
    for i, s in enumerate(trace.spans):
        if s.request is None and s.end_ns:
            out[trace.label(i)] += own[i] / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def prepare_s(trace):
    """The set-up's outermost spans (no request) summed, in s."""
    spans = [s for s in trace.spans if s.parent is None and s.request is None
             and s.end_ns]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9


def _profiled(fn):
    """(fn(), the chrome trace's events, its baseTimeNanoseconds): a
    CUDA-only torch.profiler trace, as portbench/trace.py records it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        doc = json.loads(path.read_text())
    return result, doc["traceEvents"], int(doc.get("baseTimeNanoseconds", 0))


def run_cell(cell, seed: int, seconds: float, spans: bool, device: str,
             n: int | None = None) -> dict:
    """One run of `cell` with the span recorder on or off; the result's
    fields.  On a CPU device there is no trace: the readings alone."""
    import torch

    from ans_tpu_torch.utils import stats

    from . import inputs, run, traffic

    config = dict(cell.config, **({"n": n} if n else {}))
    mix, dev = cell.mix, torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {"workload": cell.name, "seed": seed, "spans": int(spans)}
    with (stats.tracing() if spans else nullcontext()) as rec:
        t = [time.perf_counter()]
        xs = inputs.make(config, seed, dev)
        t.append(time.perf_counter())
        staged = cell.codec.program.stage(config, mix, xs, dev)
        t.append(time.perf_counter())
        traffic.warm_up(staged.calls, sync, run.SAMPLE)
        t.append(time.perf_counter())
        syncs = stats.counts["sync"]
        lo = time.perf_counter_ns()

        def loop():
            return traffic.closed_loop(staged.calls, sync, seconds,
                                       run.SAMPLE, seed,
                                       int(mix.get("clients", 1)))

        if cuda:
            window, events, base_ns = _profiled(loop)
        else:
            window, events, base_ns = loop(), None, None
        hi = time.perf_counter_ns()
        syncs = stats.counts["sync"] - syncs
    done = len(window.latencies)
    lat = sorted(window.latencies)
    out.update(
        setup_s={"input": t[1] - t[0], "encode_and_staging": t[2] - t[1],
                 "warm_up": t[3] - t[2]},
        attempted=window.attempted, failed=window.failed,
        window_s=window.seconds,
        request_ms=1e3 * sum(lat) / done if done else None,
        p95_ms=1e3 * lat[-(-95 * done // 100) - 1] if done else None,
        syncs=syncs / done if done else None)
    summary, check = (summarize(events, window.seconds, rec, base_ns)
                      if events is not None else (None, None))
    if summary is not None:
        out.update(launch_lag_us=launch_lag_us(events),
                   busy_s=summary["busy_s"],
                   idle_share=1 - summary["busy_s"] / summary["window_s"],
                   device_ops=summary["device_ops"],
                   idle_gaps=summary.get("cuda_call_gaps",
                                         summary["idle_gaps"]))
        if "cuda_call_gaps" in summary:
            out.update(labelled_gaps=summary["idle_gaps"],
                       span_share=summary["span_share"])
    if check is not None:
        out["alignment"] = check
    if rec is not None:
        requests = window_requests(rec, lo, hi)
        out.update(requests_spanned=len(requests),
                   host_ms=host_ms(rec, requests),
                   prepare_s=prepare_s(rec),
                   setup_self_s=setup_self_s(rec),
                   request_self_us=request_self_us(rec, requests))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch

    from . import manifest, run
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        _log(json.dumps({"error": "no card", "workload": cell.name}))
        return 2
    if cell.chips > 1:
        _log(json.dumps({"error": "spans runs cells of one card",
                         "workload": cell.name, "chips": cell.chips}))
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.spans), "cuda:0")
    res["card"] = run.card()
    check = res.get("alignment")
    if check is not None:
        _log(f"clock: offset {check['offset_us']:.3f} us (fitted "
             f"{check['fitted_us']:+.3f} us to the epoch clocks'), "
             f"{100 * check['inside_share']:.2f}% of "
             f"{check['launch_calls']} launch calls inside launch spans, "
             f"largest miss {check['largest_miss_us']:.3f} us, "
             f"{100 * check['anchored_share']:.2f}% of the idle seconds "
             f"anchored on launch calls"
             + ("" if check["inside_share"] >= ALIGNED
                and check["anchored_share"] >= ANCHORED else
                "; under 99%: the gaps keep the CUDA calls' labels"))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
