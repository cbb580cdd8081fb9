"""The mean wait of rank 0's requests, in ms, from its own synchronise to
the end of the ranks' rendezvous: the wait on the slower cards plus the
meeting, on rank 0's host clock (the sharded read cells).  With
`--trace 1` every rank runs under the profiler, so that rank 0 is not
slowed against the others, and this is rank 0's reading."""


def read(run):
    waits = run.window.rendezvous
    return 1e3 * sum(waits) / len(waits) if waits else None
