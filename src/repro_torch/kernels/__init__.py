# Hand-written Hopper kernels (csrc/*.cu, built on first use by build.py)
# and, beside each, its plain PyTorch version.
