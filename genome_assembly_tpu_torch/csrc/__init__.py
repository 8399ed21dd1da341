"""CUDA C++ sources of the port's kernels, and their build (build.py)."""
