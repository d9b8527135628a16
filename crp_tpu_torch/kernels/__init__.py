"""Local SpMM kernels, their plain PyTorch versions, packing and dispatch."""
