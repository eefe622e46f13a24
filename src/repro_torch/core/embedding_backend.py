"""Sparse-parameter backends: how a batch's rows reach the model.

Counterpart of ``repro/core/embedding_backend.py``.  The batch's ids are
deduplicated into a fixed-capacity working set that ends in an all-zero
drop row, and the rows are gathered into it.  ``pull`` is the training
pull, ``lookup`` the read-only serving lookup, and ``push`` applies the
sparse optimizer to the pulled rows in place.  ``plan`` is the ids-only
part of a pull or a lookup (the dedup into the fixed-capacity layout): it
reads no table and no backend state, so a prefetcher may run it for the
next batch while the current step still trains (``core.prefetch``), and
``pull`` and ``lookup`` take it, or compute it when none is given.  Two placements are ported:
``gather`` (below: the table where the model is) and ``cached``
(``core.cache_tier.CachedBackend``: a device cache over a host-resident
table), each also ``staged`` for the DiskStore (the SSD tier), where the
pull and the push see the batch's working-set rows, staged by the engine,
instead of a resident table.  The routed placement comes with ROADMAP.md
queue A8.
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

    ``staged=True`` is the DiskStore dataflow (``--store disk``): the
    ``table``/``accum`` the pull and push see are the batch's
    ``(capacity, dim)`` working-set rows, staged by the engine in
    deduplicated-uid order.  The pull appends the drop row; the push is
    ``SparseAdagrad.apply_staged`` (the staged AdaGrad kernel on the card)
    and the updated rows ride out through the table/accum outputs for the
    engine to commit.  Bit-identical to the resident path at every valid
    (first-occurrence) position.
    """

    def __init__(self, fused: bool = False, staged: bool = False):
        self.fused = fused
        self.staged = staged

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
        if self.staged:
            if table.shape[0] != capacity:
                raise ValueError(
                    f"staged pull expects ({capacity}, dim) working-set rows "
                    f"from the RowStore, got {tuple(table.shape)}")
            # the engine staged the rows in the device dedup's uid order
            # (host_dedup mirrors it), so table[i] IS the row of uids[i]
            return _with_drop_row(table)
        return _with_drop_row(table.index_select(0, uids.long()))

    @staticmethod
    def plan(flat_ids, capacity: int):
        """The ids-only part of a pull: ``(uids, inverse, n_dropped)``."""
        return _dedup(flat_ids, capacity)

    def pull(self, table, accum, state, flat_ids, capacity: int,
             plan=None):
        """Training pull: ``(WorkingSet, table, accum, state)``; the table
        tree comes back unchanged (a gather writes nothing).  ``plan``:
        ``self.plan(flat_ids, capacity)``, computed here when None."""
        uids, inv, n_dropped = (self.plan(flat_ids, capacity) if plan is None
                                else plan)
        rows = self._served_rows(table, uids, capacity)
        return WorkingSet(uids, inv, rows, n_dropped), table, accum, state

    def lookup(self, table, accum, state, flat_ids, capacity: int,
               plan=None):
        """Read-only lookup: ``(WorkingSet, aux)``.  Writes nothing; ``aux``
        meters the id slots served (``serve_lookups``, f32 scalar)."""
        uids, inv, n_dropped = (self.plan(flat_ids, capacity) if plan is None
                                else plan)
        rows = self._served_rows(table, uids, capacity)
        aux = {"serve_lookups": (float(flat_ids.numel())
                                 - n_dropped.to(torch.float32))}
        return WorkingSet(uids, inv, rows, n_dropped), aux

    def push(self, table, accum, state, ws: WorkingSet, row_grads, opt):
        """Apply ``opt`` to the working set's rows in place; the gradient of
        the drop row (``row_grads[capacity]``) is discarded.  Staged: the
        elementwise AdaGrad of the staged rows (``apply_staged``)."""
        if self.staged:
            table, accum = opt.apply_staged(
                table, accum, row_grads[: ws.uids.shape[0]])
            return table, accum, state
        table, accum = opt.apply_rows(
            table, accum, ws.uids, row_grads[: ws.uids.shape[0]],
            fused=self.fused)
        return table, accum, state


# ------------------------------------------------------------------ factory
def make_backend(placement: str, fused: bool = False, device="cuda",
                 **kwargs):
    """``placement`` -> a backend instance.

    ``fused`` selects the gather placement's push (the cached placement
    always runs its kernels through ``kernels.ops``).  ``cached`` takes
    ``cache_rows`` (the device cache size, required) and ``decay`` (the LFU
    decay, optional), and keeps its cache state on ``device``; see
    ``repro_torch.core.cache_tier.CachedBackend``.  ``staged=True``
    (gather and cached; cached then also takes ``capacity``) selects the
    DiskStore dataflow, which ``runtime.factory`` wires when
    ``store="disk"``.  The routed placement is not ported yet and raises.
    """
    if placement == "gather":
        staged = kwargs.pop("staged", False)
        if kwargs:
            raise TypeError(
                f"placement 'gather' does not accept {sorted(kwargs)} "
                f"(routed/cached-only options)"
            )
        return GatherBackend(fused=fused, staged=staged)
    if placement == "routed":
        raise NotImplementedError(
            "placement 'routed' is not ported yet; see ROADMAP.md queue A8 "
            "(routed placement)")
    if placement == "cached":
        from repro_torch.core.cache_tier import CachedBackend

        if "cache_rows" not in kwargs:
            raise TypeError("placement 'cached' requires cache_rows")
        return CachedBackend(device=device, **kwargs)
    raise ValueError(
        f"unknown placement {placement!r}; use 'gather', 'routed', or 'cached'"
    )
