"""CUDA C++ sources of the lane-engine kernels and their build (build.py)."""
