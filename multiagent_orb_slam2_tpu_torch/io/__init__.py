"""Synthetic scene generation and trajectory writers / metrics (numpy)."""
