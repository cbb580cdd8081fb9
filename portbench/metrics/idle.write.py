"""The card's idle share of the traced window, in %: 100 * (1 - busy / wall)
(the write cells)."""

from portbench.readings import idle as read  # noqa: F401
