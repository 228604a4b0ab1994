"""Build and load the package's CUDA kernels (see build.py)."""
