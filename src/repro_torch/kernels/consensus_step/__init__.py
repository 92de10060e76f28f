"""Fused consensus + tracking step (eqs. 6 and 10) and the bare combine."""
