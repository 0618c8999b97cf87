"""Numeric helpers, the sum tree, and the hand-written CUDA kernels."""
