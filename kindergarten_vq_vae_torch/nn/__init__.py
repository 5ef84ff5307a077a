"""BERT modules under the JAX package's parameter names."""
