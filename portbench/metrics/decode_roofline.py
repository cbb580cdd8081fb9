"""A decode request's share of its memory roofline, in %: the bytes it must
move (counted from its shapes by the harness) at the card's published
bandwidth, over the request's device-busy seconds in the traced window
(the read cells).  Over several ranks, rank 0's: the bytes its shard's
request moves over its card's busy seconds; every rank runs under the
profiler and rank 0's trace is read."""

from portbench.readings import roofline as read  # noqa: F401
