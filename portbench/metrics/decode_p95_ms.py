"""The 95th percentile (nearest rank) of every decode request of the window,
in ms, on the host clock around a synchronised call (the read cells)."""

from portbench.readings import p95_ms as read  # noqa: F401
