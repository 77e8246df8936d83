"""Hand-written CUDA kernels of the port, one family per directory."""
