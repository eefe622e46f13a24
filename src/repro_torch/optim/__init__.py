"""Dense optimizers: the single-replica baselines (``repro/optim``)."""
