"""The byte coder's model: the 256-symbol normaliser and its raw interp
prelude (layout of ans_byte.hpp: the 256 cumulative frequencies over the
fixed universe MAX_FRAME_SIZE + 256, no vbyte/log2 header).  The prelude
bytes are wire format.  A copy of `byte_prelude_encode` (its interp
half kept apart as `byte_prelude_serialize`), `byte_prelude_decode` and
`byte_adjust_freqs` of ans_tpu/reference_model/rans_compat.py, held equal
to them by tests/test_torch_host.py.
"""

from __future__ import annotations

import numpy as np

from ..constants import (BYTE_FRAME_FACTOR, BYTE_MAX_FRAME_SIZE,
                         BYTE_MAX_SIGMA)
from . import interp, model


def byte_prelude_serialize(nfreqs) -> bytes:
    """The interp-coded cumulative prelude of 256 normalized frequencies."""
    increasing = np.cumsum(np.asarray(nfreqs).astype(np.uint64) + 1) - 1
    return interp.encode(increasing, BYTE_MAX_SIGMA,
                         BYTE_MAX_FRAME_SIZE + BYTE_MAX_SIGMA)


def byte_prelude_encode(freqs):
    """Normalize a 256-bin histogram and interp-code the cumulative
    prelude.  Returns (prelude bytes, nfreqs)."""
    nfreqs = byte_adjust_freqs(freqs)
    return byte_prelude_serialize(nfreqs), nfreqs


def byte_prelude_decode(buf: bytes):
    """Inverse of byte_prelude_encode: (nfreqs i64 (256,), byte offset
    past the prelude)."""
    vals, words = interp.decode(buf, BYTE_MAX_SIGMA,
                                BYTE_MAX_FRAME_SIZE + BYTE_MAX_SIGMA)
    vals = np.asarray(vals, dtype=np.int64)
    # diff over a prepended -1 inverts cumsum(nfreqs + 1) - 1 at every
    # index, including 0
    nfreqs = np.diff(np.concatenate(([-1], vals))) - 1
    return nfreqs, words * 4


def byte_adjust_freqs(freqs):
    """256-symbol normalizer (reference: ans_byte.hpp:40-97)."""
    freqs = np.asarray(freqs, dtype=np.uint64)
    adj = np.zeros(BYTE_MAX_SIGMA, dtype=np.int64)
    uniq = int((freqs != 0).sum())
    initial_sum = int(freqs.sum())
    target = uniq * BYTE_FRAME_FACTOR
    if target > BYTE_MAX_FRAME_SIZE:
        target = BYTE_MAX_FRAME_SIZE
    if not model.is_power_of_two(target):
        target = model.next_power_of_two(target)
    c = target / initial_sum
    cur = 1 << 62
    fudge = 1.0
    freqs_l = freqs.tolist()
    while cur > target:
        fudge -= 0.01
        cur = 0
        for sym in range(BYTE_MAX_SIGMA):
            v = int(fudge * float(freqs_l[sym]) * c)
            if v == 0 and freqs_l[sym] != 0:
                v = 1
            adj[sym] = v
            cur += v
    excess = target - cur
    for i in range(BYTE_MAX_SIGMA):
        sym = BYTE_MAX_SIGMA - i - 1
        ncnt = int(adj[sym])
        if ncnt == 0:
            continue
        ratio = excess / cur
        adder = int(ratio * ncnt)
        if adder > excess:
            adder = excess
        excess -= adder
        cur -= ncnt
        adj[sym] += adder
    if excess != 0:
        adj[int(np.argmax(adj))] += excess
    return adj.astype(np.uint32)
