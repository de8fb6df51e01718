"""Filters and kernels: each ``*_kernel``/``whdr_gather`` module holds a
CUDA kernel's wrapper beside its plain PyTorch version."""
