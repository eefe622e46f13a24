"""Synthetic data streams (numpy, host side)."""
