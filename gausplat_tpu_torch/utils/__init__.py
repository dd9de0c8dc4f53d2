"""Build and launch support for the hand-written CUDA kernels."""
