"""NumPy host model of the wire formats: the port's own copies of the
modules of ans_tpu/reference_model that its codecs call (the frame search
and the prelude, the interpolative coder under it, the fold un-mapping and
the byte coder's normaliser).  Pure Python and NumPy; each copy is held
equal to its original by tests/test_torch_host.py.
"""

from . import (bitio, byte_model, interp, mappings, model,  # noqa: F401
               vbyte)
