"""Hand-written Pallas kernels for the hot ops (NVIDIA GPU, Triton route)."""
