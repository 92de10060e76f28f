"""Deterministic synthetic data: per-agent LM token streams."""
