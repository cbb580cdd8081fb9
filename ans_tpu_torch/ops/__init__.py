"""Device-side ops of the lane engine: tables, the fold mapping, the
plain PyTorch engine (lane_codec) and the wrappers of the three CUDA
kernels (encode, place, decode)."""
