"""All values encoded in the window over the window's seconds, in billions
a second (the write cells)."""

from portbench.readings import rate_G as read  # noqa: F401
