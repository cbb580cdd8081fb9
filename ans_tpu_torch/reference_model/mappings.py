"""Symbol-space mappings on the host: the un-fold table of the byte-fold
coders.  A copy of what the port calls from
ans_tpu/reference_model/mappings.py (ans_fold.hpp:150-175), held equal to
it by tests/test_torch_host.py.
"""

from __future__ import annotations

import numpy as np

from ..constants import fold_offset_step, fold_threshold


def fold_unmap_high(sym, fidelity: int):
    """High part reconstructed from a folded id (ans_fold.hpp:150-161)."""
    sym = np.asarray(sym, dtype=np.uint32)
    thres = np.uint32(fold_threshold(fidelity))
    div = np.uint32(fold_offset_step(fidelity))
    folded = sym >= thres
    nb = np.where(folded, (sym - thres) // div + np.uint32(1), np.uint32(0))
    high = np.where(folded,
                    (sym - div * nb) << (np.uint32(8) * nb),
                    sym)
    return high.astype(np.uint32), nb.astype(np.uint32)
