"""ans_tpu_torch: the codecs, containers and experiment drivers of
`ans_tpu` on PyTorch and CUDA (NVIDIA Hopper).

The JAX package `ans_tpu` is the reference: this package writes the same
wire bytes (docs/FORMAT.md, fmt 2) and decodes every blob it writes.  It
imports `torch`, never `jax` and nothing of `ans_tpu`: the NumPy host
modules it needs (`constants`, `reference_model`, the host codecs of
`models`, `utils`, `drivers`) are its own copies, held equal to the
originals by tests/test_torch_host.py.

Every public entry point takes an explicit `device`.  On a CUDA device
the codecs run hand-written kernels (ans_tpu_torch/csrc/); on the CPU
each kernel's wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
