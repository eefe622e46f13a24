"""Runtimes: the hybrid trainer, the CTR server, the factory, metrics."""
