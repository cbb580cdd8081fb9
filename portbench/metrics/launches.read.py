"""Decode launches (K3, K4, K5) per request of the window, from the
program's launch counters (the read cells; one launch decodes every
section of a blocked container).  Over several ranks, rank 0's counters:
every rank launches alike."""

from portbench.readings import launches


def read(run):
    return launches(run, "decode")
