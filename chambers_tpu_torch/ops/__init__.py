"""Image primitives and the hand-written CUDA kernels of the port."""
