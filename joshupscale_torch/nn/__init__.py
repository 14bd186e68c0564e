"""Functional layers (inference subset)."""
