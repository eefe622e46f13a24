"""Sparse-parameter backends: how a batch's rows reach the model.

Counterpart of ``repro/core/embedding_backend.py``, for the gather
placement: the batch's ids are deduplicated into a fixed-capacity working
set that ends in an all-zero drop row, and the table rows are gathered into
it.  ``pull`` is the training pull, ``lookup`` the read-only serving lookup
(the gather placement is stateless, so the two serve the same rows), and
``push`` applies the sparse optimizer to the pulled rows in place.  The
routed and cached placements come with their own slices (ROADMAP queue A).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


# --------------------------------------------------------------- working set
def pull_working_set(flat_ids: torch.Tensor,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deduplicate a batch's ids (the PS "pull" manifest).

    Returns (unique_ids (capacity,), inverse (nnz,)) laid out as the
    reference's ``jnp.unique(size=capacity, fill_value=None,
    return_inverse=True)``: ascending, truncated to ``capacity`` keeping the
    smallest ids, padded by repeating the smallest id.  ``inverse`` indexes
    the untruncated unique ids, so an id cut by the truncation has
    ``inverse >= capacity``.
    """
    u, inv = torch.unique(flat_ids, sorted=True, return_inverse=True)
    uids = u[:capacity]
    if uids.shape[0] < capacity:
        pad = u[:1].expand(capacity - uids.shape[0])
        uids = torch.cat([uids, pad])
    return uids.to(torch.int32), inv.to(torch.int32)


class WorkingSet(NamedTuple):
    """One table's pulled rows for one batch (Algorithm 1 line 3).

    ``rows`` carries one extra all-zero "drop" row at index ``capacity``:
    id slots beyond the dedup capacity have ``inverse == capacity``, so they
    read zeros (and are counted) instead of indexing out of range.
    """

    uids: torch.Tensor       # (capacity,) int32 — deduplicated ids, padded
    inverse: torch.Tensor    # (nnz,) int32 — original id slot -> working row
    rows: torch.Tensor       # (capacity + 1, dim); rows[capacity] == 0
    n_dropped: torch.Tensor  # () int32 — ids not served (capacity overflow)


def _dedup(flat_ids: torch.Tensor, capacity: int):
    """(uids, inverse, n_dropped): slots of ids beyond ``capacity`` point at
    the zero drop row ``capacity``."""
    uids, inv = pull_working_set(flat_ids, capacity)
    served = inv < capacity
    inverse = torch.where(served, inv, capacity).to(torch.int32)
    return uids, inverse, (~served).sum(dtype=torch.int32)


def _with_drop_row(rows: torch.Tensor) -> torch.Tensor:
    return torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])


# ------------------------------------------------------------------- gather
class GatherBackend:
    """Dedup + ``index_select`` gather over a table in logical layout (row i
    holds feature id i).  Stateless: the backend state is an empty tuple.

    ``fused=True`` routes the push through ``ops.sparse_adagrad_apply`` (the
    CUDA kernel on the card); ``fused=False`` is the plain scatter, which
    only CPU tensors take.  Both are bit-identical.
    """

    def __init__(self, fused: bool = False):
        self.fused = fused

    def init_state(self, table: torch.Tensor):
        return ()

    def prepare(self, table: torch.Tensor) -> torch.Tensor:
        return table

    def export(self, table: torch.Tensor) -> torch.Tensor:
        return table

    def flush(self, table, accum, state):
        return table, accum, state

    def _served_rows(self, table, uids, capacity: int) -> torch.Tensor:
        """(capacity + 1, dim) rows for ``uids``."""
        return _with_drop_row(table.index_select(0, uids.long()))

    def pull(self, table, accum, state, flat_ids, capacity: int):
        """Training pull: ``(WorkingSet, table, accum, state)``; the table
        tree comes back unchanged (a gather writes nothing)."""
        uids, inv, n_dropped = _dedup(flat_ids, capacity)
        rows = self._served_rows(table, uids, capacity)
        return WorkingSet(uids, inv, rows, n_dropped), table, accum, state

    def lookup(self, table, accum, state, flat_ids, capacity: int):
        """Read-only lookup: ``(WorkingSet, aux)``.  Writes nothing; ``aux``
        meters the id slots served (``serve_lookups``, f32 scalar)."""
        uids, inv, n_dropped = _dedup(flat_ids, capacity)
        rows = self._served_rows(table, uids, capacity)
        aux = {"serve_lookups": (float(flat_ids.numel())
                                 - n_dropped.to(torch.float32))}
        return WorkingSet(uids, inv, rows, n_dropped), aux

    def push(self, table, accum, state, ws: WorkingSet, row_grads, opt):
        """Apply ``opt`` to the working set's rows in place; the gradient of
        the drop row (``row_grads[capacity]``) is discarded."""
        table, accum = opt.apply_rows(
            table, accum, ws.uids, row_grads[: ws.uids.shape[0]],
            fused=self.fused)
        return table, accum, state


# ------------------------------------------------------------------ factory
_UNPORTED = {"routed": "A8 (routed placement)",
             "cached": "A4 (cached placement)"}


def make_backend(placement: str, fused: bool = False) -> GatherBackend:
    """``placement`` -> a backend instance ("gather" is the one ported).
    ``fused`` selects the push kernel (see ``GatherBackend``)."""
    if placement == "gather":
        return GatherBackend(fused=fused)
    if placement in _UNPORTED:
        raise NotImplementedError(
            f"placement {placement!r} is not ported yet; see ROADMAP.md "
            f"queue {_UNPORTED[placement]}")
    raise ValueError(
        f"unknown placement {placement!r}; use 'gather', 'routed', or 'cached'"
    )

