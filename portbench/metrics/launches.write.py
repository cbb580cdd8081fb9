"""Encode-scan (K1, K6) and placement (K2) launches per request of the
window, from the program's launch counters (the write cells)."""

from portbench.readings import launches


def read(run):
    return launches(run, "encode", "place")
