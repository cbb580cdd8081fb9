"""The card's idle share of the traced window, in %: 100 * (1 - busy / wall)
(the read cells).  Over several ranks, rank 0's card: every rank runs
under the profiler and rank 0's trace is read."""

from portbench.readings import idle as read  # noqa: F401
