"""All values decoded in the window over the window's seconds, in billions
a second (the read cells)."""

from portbench.readings import rate_G as read  # noqa: F401
