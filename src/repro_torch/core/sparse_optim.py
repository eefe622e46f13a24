"""Sparse AdaGrad on embedding working sets (paper §5 hybrid optimizer split).

Counterpart of ``repro/core/sparse_optim.py``.  The serving path reads the
accumulator (a lookup takes it) but never updates it, so only the config,
the state and its initialisation are here; the row update (``apply_rows``)
comes with the training slice (ROADMAP queue A, slice 2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class SparseAdagradConfig:
    lr: float = 0.05
    eps: float = 1e-10
    initial_accumulator: float = 0.1   # paddlepaddle/TF AdaGrad convention


class SparseAdagradState(NamedTuple):
    accum: Dict[str, torch.Tensor]  # per-table accumulator, table-shaped, f32


class SparseAdagrad:
    """Working-set AdaGrad over a dict of embedding tables."""

    def __init__(self, cfg: SparseAdagradConfig = SparseAdagradConfig()):
        self.cfg = cfg

    def init(self, tables: Dict[str, torch.Tensor]) -> SparseAdagradState:
        return SparseAdagradState(accum={
            n: torch.full(t.shape, self.cfg.initial_accumulator,
                          dtype=torch.float32, device=t.device)
            for n, t in tables.items()
        })
