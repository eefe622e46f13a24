"""Sparse AdaGrad on embedding working sets (paper §5 hybrid optimizer split).

Counterpart of ``repro/core/sparse_optim.py``.  The sparse gradient touches
only the working set (the deduplicated rows of the current batch), so the
update is a scatter over the batch's unique row ids: the PS "push".  The
table and the accumulator are updated in place (the port's counterpart of
the reference's buffer donation), and the functions return the same
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.sparse_adagrad import adagrad_row_updates


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

    def apply_rows(self, table, accum, unique_ids, row_grads,
                   fused: bool = False):
        """Scatter one working set back into its table (the PS "push"), in
        place; returns ``(table, accum)``.

        The row arithmetic is ``kernels.sparse_adagrad.adagrad_row_updates``
        either way.  ``fused=True`` runs ``ops.sparse_adagrad_apply`` (the
        CUDA kernel on the card, its plain version on the CPU); ``fused=False``
        is the plain ``index_add_`` scatter, bit-identical to it, and is
        accepted only for CPU tensors (the card has no unfused path).  Pad
        slots repeat a real id with zero grads, which leave the row's bits
        unchanged.
        """
        if fused:
            return ops.sparse_adagrad_apply(
                table, accum, unique_ids, row_grads,
                lr=self.cfg.lr, eps=self.cfg.eps)
        if ops.kernel_mode(table) != "ref":
            raise ValueError("apply_rows(fused=False) on CUDA tensors: the "
                             "push runs on the card only as its CUDA kernel")
        delta, g2 = adagrad_row_updates(
            accum.index_select(0, unique_ids.long()), row_grads, table.dtype,
            lr=self.cfg.lr, eps=self.cfg.eps)
        ops.launches["sparse_adagrad_apply_ref"] += 1
        return ref.sparse_adagrad_apply_ref(table, accum, unique_ids, delta,
                                            g2)

    def apply_staged(self, rows, accum_rows, row_grads):
        """Working-set-aligned AdaGrad: the DiskStore's staged push, in
        place; returns ``(rows, accum_rows)``.

        ``rows``/``accum_rows`` are the batch's ``(capacity, dim)`` rows in
        deduplicated-uid order (the engine staged them), so the update is
        elementwise: ``ops.sparse_adagrad`` (the CUDA kernel on the card,
        its plain version on the CPU, counted).  Position i ends bit-equal
        to row ``uids[i]`` after ``apply_rows`` on a resident table (the
        same ``adagrad_row_updates`` bits); the pads' zero gradients leave
        their rows as they were.
        """
        return ops.sparse_adagrad(rows, accum_rows, row_grads,
                                  lr=self.cfg.lr, eps=self.cfg.eps)

    def step(self, tables, state: SparseAdagradState, updates):
        """``updates``: ``{name: (unique_ids, row_grads)}`` matching
        ``tables``; every table is updated in place by the unfused scatter
        (CPU tensors)."""
        for name, (ids, rg) in updates.items():
            self.apply_rows(tables[name], state.accum[name], ids, rg)
        return tables, state

    def dense_reference(self, table, accum, grads):
        """Dense AdaGrad oracle (same math on a full-size gradient; tests
        only).  Returns new tensors."""
        g = grads.to(torch.float32)
        a = accum + torch.square(g)
        new_table = table - (self.cfg.lr * g
                             / (torch.sqrt(a) + self.cfg.eps)).to(table.dtype)
        return new_table, a
