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

Over several ranks, each holding its shard of every array
(`closed_loop_ranks`), a request is one call on each rank, each on its
own card, then one rendezvous of the ranks: the request ends when the
slowest card has decoded its shard, which is what a reader of the whole
array waits for.  Every rank makes the same requests and keeps the same
sample.
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
    rendezvous: list = field(default_factory=list)  # seconds, per request:
    #                              from this rank's sync to the meeting's end


def warm_up(calls: list, sync: Callable, held: int):
    """Run the calls in turn, each twice and `held + 2` calls at least,
    holding the last `held` outputs, as the window will."""
    outs = []
    for i in range(max(held + 2, 2 * len(calls))):
        outs.append(calls[i % len(calls)]())
        sync()
        outs = outs[-held:] if held else []
    del outs


class Sample:
    """Reservoir sampling of `size` outputs over every request of a
    window, from the seed's uniform draws, made in bulk."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.pick = np.random.default_rng((seed % (1 << 64), 1))
        self.draws, self.at = [], 0

    def offer(self, kept: dict, i: int, out) -> None:
        if i < self.size:
            kept[i] = out
        elif self.size:
            if self.at == len(self.draws):
                self.draws, self.at = self.pick.random(1 << 12).tolist(), 0
            j = int(self.draws[self.at] * (i + 1))
            self.at += 1
            if j < self.size:
                kept.pop(sorted(kept)[j])
                kept[i] = out


def closed_loop(calls: list, sync: Callable, seconds: float,
                sample: int, seed: int, clients: int = 1) -> Window:
    if clients != 1:
        raise ValueError(f"the generator runs one client, not {clients}")
    keep = Sample(sample, seed)
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
        keep.offer(w.kept, i, out)
        del out
    w.seconds = end - start
    return w


def closed_loop_ranks(calls: list, sync: Callable, seconds: float,
                      sample: int, seed: int,
                      meet: Callable[[int, int], tuple],
                      lead: bool) -> Window:
    """One client a rank, the ranks in step: a request calls this rank's
    next staged object, synchronises its card, then meets the other ranks
    (`meet(failed, stop)` sums both over the ranks).  The lead rank sets
    `stop` once `seconds` have passed.  A request that raises on any rank
    is failed on every rank, keeps no output and ends every window; the
    raising rank still meets the others, so none is left waiting.  The
    lead rank's latencies run from its call to the meeting's end."""
    keep = Sample(sample, seed)
    w = Window()
    clock = time.perf_counter
    start = clock()
    end = start
    while True:
        i = w.attempted
        w.attempted += 1
        t0 = clock()
        out, error = None, None
        try:
            out = calls[i % len(calls)]()
            sync()
        except Exception as exc:  # meets the others, then ends the window
            error = f"{type(exc).__name__}: {exc}"
        synced = clock()
        failed, stop = meet(int(error is not None),
                            int(lead and synced - start >= seconds))
        end = clock()
        if failed:
            w.failed += 1
            w.error = error or f"a request failed on {failed} other rank(s)"
            break
        w.latencies.append(end - t0)
        w.rendezvous.append(end - synced)
        keep.offer(w.kept, i, out)
        del out
        if stop:
            break
    w.seconds = end - start
    return w
