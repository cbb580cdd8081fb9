"""An encode request's share of its memory roofline, in %: the bytes it must
move (counted from its shapes by the harness) at the card's published
bandwidth, over the request's device-busy seconds in the traced window
(the write cells)."""

from portbench.readings import roofline as read  # noqa: F401
