"""Utilities: the JAX -> port weight bridge."""
