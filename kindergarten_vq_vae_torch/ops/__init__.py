"""The kernels (csrc/) with their plain PyTorch versions: the layer forward and
backward, hash dropout, the VQ bottleneck and the streaming cross-entropy."""
