"""Build and launch support for the hand-written CUDA kernels, the host
C++ PLY codec, and profiling helpers."""
