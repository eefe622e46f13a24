"""Embedding engine: the one facade over the sparse-parameter path.

Counterpart of ``repro/core/embedding_engine.py``.  The engine owns the
``TableSpec``s, the working-set capacity, the sparse optimizer, the
placement backend and the row store:

  1. ``pull_batch(tables, accum, states, batch)``: one training pull per
     table -> ``(wss, tables, accum, states)`` (Algorithm 1 line 3);
  2. ``lookup_batch(tables, accum, states, batch)``: one read-only lookup
     per table -> ``({name: WorkingSet}, aux)``;
  3. ``bag_from_working``: the per-field bags over the working set, by the
     hand-written CUDA kernels on the card (``kernels.ops``);
  4. ``push(tables, accum, states, wss, row_grads)``: the sparse optimizer
     applied to each working set, in place (Algorithm 1 line 13).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.embedding_backend import (  # noqa: F401  (re-exported API)
    GatherBackend,
    WorkingSet,
    make_backend,
    pull_working_set,
)
from repro_torch.core.row_store import HostStore
from repro_torch.core.sparse_optim import (
    SparseAdagrad,
    SparseAdagradConfig,
    SparseAdagradState,
)
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Shape + batch wiring of one embedding table.

    ``id_field`` names the batch key(s) holding this table's ids: ``None``
    means the table name, a string one key, a tuple several keys whose
    per-instance ids are concatenated (instance-major).  ``id_col`` selects
    one column of a (batch, n) id tensor.
    """

    name: str
    rows: int
    dim: int
    combiner: str = "sum"
    dtype: torch.dtype = torch.float32
    id_field: Optional[Union[str, Sequence[str]]] = None
    id_col: Optional[int] = None


class EmbeddingEngine:
    """Owns the tables' specs, capacity, sparse optimizer, backend and store.

    ``optimizer`` may be a ``SparseAdagrad``, a ``SparseAdagradConfig`` or
    ``None`` (defaults); ``backend`` defaults to ``GatherBackend``.  Tables
    live on ``device`` (CUDA unless the caller asks for the CPU).
    """

    def __init__(self, specs: Dict[str, TableSpec], capacity: int,
                 optimizer=None, backend=None, store=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.specs = dict(specs)
        self.capacity = int(capacity)
        if optimizer is None:
            optimizer = SparseAdagrad()
        elif isinstance(optimizer, SparseAdagradConfig):
            optimizer = SparseAdagrad(optimizer)
        self.opt: SparseAdagrad = optimizer
        self.backend = backend if backend is not None else GatherBackend()
        self.store = store if store is not None else HostStore()

    # ------------------------------------------------------------ lifecycle
    def init(self, generator: torch.Generator,
             scale: float = 0.01) -> Dict[str, torch.Tensor]:
        """Random-normal logical init (tables in name order, drawn one after
        the other from ``generator``, which must live on the engine's
        device), converted to the backend's layout."""
        tables = {}
        for name, spec in sorted(self.specs.items()):
            t = torch.empty((spec.rows, spec.dim), dtype=torch.float32,
                            device=self.device)
            t.normal_(generator=generator).mul_(scale)
            tables[name] = self.backend.prepare(t.to(spec.dtype))
        return tables

    def init_state(self, tables: Dict[str, torch.Tensor]) -> SparseAdagradState:
        return self.opt.init(tables)

    def init_backend_state(self, tables: Dict[str, torch.Tensor]):
        """Per-table backend state (empty tuples when stateless)."""
        return {n: self.backend.init_state(t) for n, t in tables.items()}

    # ----------------------------------------------------------------- ids
    def ids_from_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Each table's flattened id tensor from a batch dict (instance-major,
        so the inverse map stays sliceable per instance)."""
        out = {}
        for name, spec in self.specs.items():
            field = spec.id_field or name
            if isinstance(field, (tuple, list)):
                ids = torch.cat([batch[f].reshape(batch[f].shape[0], -1)
                                 for f in field], dim=1)
            else:
                ids = batch[field]
                if spec.id_col is not None:
                    ids = ids[..., spec.id_col]
            out[name] = ids.reshape(-1)
        return out

    # ------------------------------------------------------------ training
    def pull(self, tables, accum, states, flat_ids: Dict[str, torch.Tensor]):
        """Algorithm 1 line 3: one working-set pull per table.  Returns
        ``(working_sets, tables, accum, states)``."""
        wss, new_tables, new_accum, new_states = {}, {}, {}, {}
        for name, ids in flat_ids.items():
            ws, nt, na, ns = self.backend.pull(
                tables[name], accum[name], states[name], ids, self.capacity)
            wss[name] = ws
            new_tables[name], new_accum[name], new_states[name] = nt, na, ns
        return wss, new_tables, new_accum, new_states

    def pull_batch(self, tables, accum, states, batch):
        return self.pull(tables, accum, states, self.ids_from_batch(batch))

    def pull_stage(self):
        """The PULL stage ``(tables, accum, states, flat_ids) -> (wss,
        tables, accum, states)``.  PyTorch runs eagerly, so the stage is
        ``pull`` itself."""
        return self.pull

    @staticmethod
    def commit(pulled):
        """Hand a pull's ``(wss, tables, accum, states)`` to the train stage
        (the serialization point of the reference's prefetch protocol; with
        eager, synchronous pulls nothing happens here)."""
        return pulled

    def push(self, tables, accum, states, working_sets: Dict[str, WorkingSet],
             row_grads):
        """Algorithm 1 line 13: each working set's row gradients applied by
        the backend, in place.  Returns ``(tables, accum, states)``."""
        new_tables, new_accum, new_states = {}, {}, {}
        for name, ws in working_sets.items():
            nt, na, ns = self.backend.push(
                tables[name], accum[name], states[name], ws, row_grads[name],
                self.opt)
            new_tables[name], new_accum[name], new_states[name] = nt, na, ns
        return new_tables, new_accum, new_states

    # ------------------------------------------------- read-only lookup path
    def lookup(self, tables, accum, states, flat_ids: Dict[str, torch.Tensor]):
        """Read-only serving lookup: ``({name: WorkingSet}, aux)``.  Serves
        the rows a pull would serve and writes nothing; ``aux`` sums the
        backends' serve meters across tables."""
        wss, aux_tot = {}, {}
        for name, ids in flat_ids.items():
            ws, aux = self.backend.lookup(
                tables[name], accum[name], states[name], ids, self.capacity)
            wss[name] = ws
            for k, v in aux.items():
                aux_tot[k] = aux_tot.get(k, 0.0) + v
        return wss, aux_tot

    def lookup_batch(self, tables, accum, states, batch):
        return self.lookup(tables, accum, states, self.ids_from_batch(batch))

    def lookup_stage(self):
        """The LOOKUP stage ``(tables, accum, states, flat_ids) -> (wss,
        aux)``.  PyTorch runs eagerly, so the stage is ``lookup`` itself; it
        consumes none of the live training tensors."""
        return self.lookup

    @staticmethod
    def overflow(working_sets: Dict[str, WorkingSet]) -> torch.Tensor:
        """Total dropped (unserved) id slots this batch."""
        return sum(ws.n_dropped for ws in working_sets.values())

    # ----------------------------------------------------------------- bags
    @staticmethod
    def bag_from_working(working: torch.Tensor, inverse: torch.Tensor,
                         segment_ids: torch.Tensor, num_bags: int,
                         weights: Optional[torch.Tensor] = None,
                         combiner: str = "sum",
                         fused: bool = True) -> torch.Tensor:
        """Bag lookup through the pulled working set (differentiable in
        ``working``).  On CUDA tensors the forward and the backward are the
        CUDA kernels (``fused=False`` raises there: CUDA has no unfused
        path); on CPU tensors the plain version, whatever ``fused`` says."""
        return ops.embedding_bag_working(working, inverse, segment_ids,
                                         weights, num_bags, combiner,
                                         fused=fused)

    def memory_bytes(self) -> int:
        return sum(s.rows * s.dim * s.dtype.itemsize
                   for s in self.specs.values())
