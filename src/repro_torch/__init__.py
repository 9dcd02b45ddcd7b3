"""OpenACM on PyTorch and CUDA: the port of the `repro` JAX package.

It mirrors the JAX package's layout (core/, kernels/, models/, configs/,
serving/, launch/) and never imports it or JAX.  Entry points run on a
CUDA device unless the caller passes ``device="cpu"``, where the GPU
kernels' plain PyTorch versions run instead.
"""
