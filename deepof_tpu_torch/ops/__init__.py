"""Per-frame tensor ops and the two hand-written CUDA kernels' wrappers."""
