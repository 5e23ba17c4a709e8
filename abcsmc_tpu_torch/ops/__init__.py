"""Tensor ops of the port: stats, PLS, weights, resampling, and the
hand-written CUDA kernel (ops.kernels)."""
