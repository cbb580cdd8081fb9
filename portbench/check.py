"""The comparison that decides `correct`.

The configuration's guarantee is lossless coding on the lane-format wire,
so every number compared is a count of what differs from the plain
reference (the reference side of the configuration's codec,
portbench/manifest.py), held to the limit 0:

  * blob_bytes_wrong  bytes of the set-up's blobs of the checked arrays
                      that differ from the reference's blobs (plus the
                      differences in length);
  * bpi_gap           the largest |bits per int of such a blob - the
                      reference's|;
  * values_wrong      decoded values that differ from the input array
                      each decoded, over the sampled requests of the
                      window (read cells);
  * stream_bytes_wrong / states_wrong
                      bytes of the stream and lane states that sampled
                      encodes returned and that differ from the
                      reference's encoding of their arrays (write cells).

Nothing to compare (no sample) counts as wrong.
"""

from __future__ import annotations

import numpy as np
import torch

LIMIT = 0  # exact comparisons


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of a and b that differ, plus the difference in length."""
    a, b = a.reshape(-1), b.reshape(-1)
    m = min(a.numel(), b.numel())
    return (int((a[:m] != b[:m]).sum()) + abs(a.numel() - b.numel()))


def blob(pairs: list, n: int) -> dict:
    """pairs: (the program's blob, the reference's) of each checked
    array."""
    wrong, gap = 0, 0.0
    for prog, ref in pairs:
        a = torch.from_numpy(np.frombuffer(prog, dtype=np.uint8).copy())
        b = torch.from_numpy(np.frombuffer(ref, dtype=np.uint8).copy())
        wrong += _differ(a, b)
        gap = max(gap, abs(8 * len(prog) / n - 8 * len(ref) / n))
    if not pairs:
        return {"blob_bytes_wrong": 1, "bpi_gap": float("inf")}
    return {"blob_bytes_wrong": wrong, "bpi_gap": gap}


def values(pairs: list) -> dict:
    """pairs: (the (n,) i32 values a checked decode returned, the input
    array it decoded)."""
    if not pairs:
        return {"values_wrong": 1}
    wrong = 0
    for got, x in pairs:
        ref = torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(
            np.int32)).to(got.device)
        wrong += _differ(got, ref)
    return {"values_wrong": wrong}


def streams(pairs: list, device) -> dict:
    """pairs: ((stream u8, states i32) a checked encode returned, the
    reference's encoding of its array: streams, one a section, and (D, S)
    u32 states)."""
    if not pairs:
        return {"stream_bytes_wrong": 1, "states_wrong": 1}
    s_wrong = t_wrong = 0
    for (stream, states), ref in pairs:
        ref_s = torch.from_numpy(np.concatenate(ref.streams)).to(device)
        ref_t = torch.from_numpy(np.ascontiguousarray(ref.states).view(
            np.int32)).to(device)
        s_wrong += _differ(stream, ref_s)
        t_wrong += _differ(states, ref_t)
    return {"stream_bytes_wrong": s_wrong, "states_wrong": t_wrong}


def passed(checks: dict) -> bool:
    return all(v <= LIMIT for v in checks.values())
