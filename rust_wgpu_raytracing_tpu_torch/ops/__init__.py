"""Frame operations: culling math, the split frame and its kernels."""
