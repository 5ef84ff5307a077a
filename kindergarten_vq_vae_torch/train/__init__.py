"""The training step: losses, the AMSGrad optimizer, per-model loss functions."""
