"""Optimizers as ``(init, update)`` pairs on pytrees."""
