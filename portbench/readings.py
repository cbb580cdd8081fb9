"""What the metric readers (metrics/<name>.py) share.  BENCHMARK.json's
`workloads` alone says which cells report a metric; a reader returns
None only where its run has nothing to read.

`run` holds the window (portbench/traffic.py), the traced window's
summary (portbench/trace.py) or None, the program's launch counts over
the window, the set-up's seconds, the pool's blob bits and size, the
bytes a request must move and the card's published bandwidth."""

import math


def rate_G(run):
    """Values coded in the window over its seconds, in billions a second:
    requests completed times n."""
    done = len(run.window.latencies)
    if not done or not run.window.seconds:
        return None
    return done * run.n / run.window.seconds / 1e9


def p95_ms(run):
    """The 95th percentile (nearest rank) of every request's latency."""
    lat = sorted(run.window.latencies)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3


def launches(run, *counters):
    """The named launch counters' sum per completed request."""
    done = len(run.window.latencies)
    if not done:
        return None
    return sum(run.launches[c] for c in counters) / done


def roofline(run):
    """A request's share of its memory roofline, in %: the bytes it must
    move at the card's published bandwidth over its device-busy seconds
    in the traced window."""
    t, done = run.trace, len(run.window.latencies)
    if t is None or not run.peak_bytes_per_s or not done or not run.bytes:
        return None
    return 100 * run.bytes / run.peak_bytes_per_s / (t["busy_s"] / done)


def idle(run):
    """The card's idle share of the traced window, in %."""
    t = run.trace
    if t is None:
        return None
    return 100 * (1 - t["busy_s"] / t["window_s"])
