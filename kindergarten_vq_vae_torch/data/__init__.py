"""Tokenizers over the JAX package's tokenizer files."""
