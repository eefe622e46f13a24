"""Runtimes: the hybrid trainer, the CTR server, the LM's batched server,
the factory, metrics."""
