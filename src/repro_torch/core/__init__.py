"""Sparse-parameter core: engine, placement backends, row store, optimizer."""
