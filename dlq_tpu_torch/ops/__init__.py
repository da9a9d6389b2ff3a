"""Quantized ops and the wrappers of the hand-written CUDA kernels."""
