"""Layer and VQ forward kernels (csrc/) with their plain PyTorch versions."""
