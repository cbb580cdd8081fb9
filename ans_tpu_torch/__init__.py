"""ans_tpu_torch: the lane-format ANS codecs of `ans_tpu` on PyTorch and
CUDA (NVIDIA Hopper).

The JAX package `ans_tpu` is the reference: this package writes the same
wire bytes (docs/FORMAT.md, fmt 2) and decodes every blob it writes.  It
imports `torch` and never `jax`; of `ans_tpu` it imports only
`ans_tpu.constants` and `ans_tpu.reference_model`, which are NumPy.

Every public entry point takes an explicit `device`.  On a CUDA device
the lane engine runs three hand-written kernels (ans_tpu_torch/csrc/);
on the CPU each kernel's wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
