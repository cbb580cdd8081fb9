"""The traffic generator: a closed loop of requests against the staged calls.

One client sends its next request when the last one has returned: a
request is one call of the next staged object of the pool, in turn (the
request i calls the array i mod P), ended by a device synchronise, timed
on the host clock.  The window opens before the first request and closes after the
request that is running when `seconds` have passed; its rate is taken
over all of its requests and all of its time.

A sample of the requests' outputs, drawn from the seed over every request
of the window (reservoir sampling), is kept for the check that follows
the window.  The warm-up runs the call with as many outputs held, so that
the window allocates nothing new, and calls every array of the pool.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class Window:
    latencies: list = field(default_factory=list)  # seconds, per request
    attempted: int = 0
    failed: int = 0
    error: str | None = None
    seconds: float = 0.0       # from the first request's start to the
    #                            last one's end
    kept: dict = field(default_factory=dict)  # request index -> output;
    #                                           its array: index mod pool


def warm_up(calls: list, sync: Callable, held: int):
    """Run the calls in turn, each twice and `held + 2` calls at least,
    holding the last `held` outputs, as the window will."""
    outs = []
    for i in range(max(held + 2, 2 * len(calls))):
        outs.append(calls[i % len(calls)]())
        sync()
        outs = outs[-held:] if held else []
    del outs


def closed_loop(calls: list, sync: Callable, seconds: float,
                sample: int, seed: int, clients: int = 1) -> Window:
    if clients != 1:
        raise ValueError(f"the generator runs one client, not {clients}")
    pick = np.random.default_rng((seed % (1 << 64), 1))
    draws, at = [], 0  # uniform draws of the reservoir, made in bulk
    w = Window()
    clock = time.perf_counter
    start = clock()
    end = start
    while end - start < seconds:
        i = w.attempted
        w.attempted += 1
        t0 = clock()
        try:
            out = calls[i % len(calls)]()
            sync()
        except Exception as exc:  # a failed request ends the window
            w.failed += 1
            w.error = f"{type(exc).__name__}: {exc}"
            end = clock()
            break
        end = clock()
        w.latencies.append(end - t0)
        if i < sample:
            w.kept[i] = out
        elif sample:
            if at == len(draws):
                draws, at = pick.random(1 << 12).tolist(), 0
            j = int(draws[at] * (i + 1))
            at += 1
            if j < sample:
                w.kept.pop(sorted(w.kept)[j])
                w.kept[i] = out
        del out
    w.seconds = end - start
    return w
