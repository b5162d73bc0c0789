"""Operators of the port; the fused conv holds the CUDA kernels."""
