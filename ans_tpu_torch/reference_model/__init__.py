"""NumPy host model of the wire formats: the port's own copies of the
modules of ans_tpu/reference_model (the frame search and the prelude, the
interpolative coder under it, the mappings, the byte coder's normaliser,
the compat coders, the shuff compat codec and the parity helpers).  Each
copy is held equal to its original by tests/test_torch_host.py; the hot
loops of model, interp and rans_compat run in the port's host library
(ans_tpu_torch/native), their pure-Python bodies the plain versions.
"""

from . import (bitio, byte_model, interp, mappings, model,  # noqa: F401
               vbyte)
