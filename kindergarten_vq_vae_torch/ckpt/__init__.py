"""Flat-npy checkpoints and the Flax param-tree bridge."""
