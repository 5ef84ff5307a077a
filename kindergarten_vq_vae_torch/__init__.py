"""PyTorch + CUDA port of the Kindergarten-VQ-VAE serving path (see README, "PyTorch port")."""
