"""Bucketed reconstructor and its HTTP front-end."""
