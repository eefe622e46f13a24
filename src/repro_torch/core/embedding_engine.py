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
     applied to each working set, in place (Algorithm 1 line 13);
  5. ``flush`` / ``export``: deferred writes (the cache tier's dirty rows)
     back into the tables, and the tables in logical layout;
  6. ``cache_counters`` / ``derive_cache_stats`` / ``cache_stats``: the
     cache tier's and the store's meters ({} for the stateless gather
     placement on the host store).

Under the ``DiskStore`` (the SSD tier, ``--store disk``) the tables live in
the store's page files and the backend is staged (``staged=True``): the
"tables" and "accumulators" the pull and push see are the batch's
``(capacity, dim)`` working-set rows, which the engine stages out of the
store and commits back, in the order of docs/storage.md "Dataflow" (the
reference's ``_disk_pull_stage``):

  1. the batch's ids come to the host and are deduplicated there
     (``host_dedup``, the device dedup's layout bit for bit);
  2. ``readahead`` queues their pages for the store's reader thread;
  3. ``absorb_staged`` commits the previous step's staged outputs into the
     store (the gather placement's pushed rows at their first-occurrence
     positions; the cached placement's evicted dirty rows by
     ``spill_uid``); its device-to-host copy waits for the previous step;
  4. ``gather`` reads the rows in uid order into pinned staging buffers;
  5. the rows go to the device, and the backend's pull runs on them.

``stage_lookup`` is the read-only counterpart for serving: it reads pages
with ``serve=True`` and overlays the pending staged outputs instead of
absorbing them, so a predict writes nothing.  ``sync_store`` is the commit
point (absorb, the device cache's dirty rows, ``flush``).  The explicit
device <-> host copies are the one deliberate host boundary of the path,
as in the reference.

``pull_async`` is the reference's contract for the pull prefetch
(``core.prefetch``): it issues a batch's pull before the batch's step, in
two parts.  The plan (``plan``: staging the batch, each table's dedup into
the fixed-capacity layout and, on the DiskStore, the host dedup) reads no
table; on the card it runs on a side stream, so the host size reads of its
``torch.unique`` wait for that stream only, not for the step still queued
on the main stream.  The table part (the gather, or the cached probe,
victims, spills and fetch; on the DiskStore read-ahead -> absorb -> gather
-> upload) then runs on the main stream after an event wait, which orders
it after the previous step's push.  On the DiskStore the plan takes the
batch's ids from the host batch instead of copying them back from the
card, so ``readahead`` is queued before ``absorb_staged`` waits for the
previous step.  On the CPU the same calls run in order, with no streams.
Both parts are the synchronous pull's own code, so the pulled values are
the same bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device, tree_map
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


class PullPlan(NamedTuple):
    """The ids-only part of a pull, per table: ``device`` the backend's plan
    (``backend.plan``), ``host`` the DiskStore's ``(uids, valid)`` from
    ``host_dedup`` (None under the host store)."""

    device: Dict[str, Any]
    host: Optional[Dict[str, Any]]


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
        staged = bool(getattr(self.backend, "staged", False))
        if self.store.kind == "disk" and not staged:
            raise ValueError(
                "DiskStore requires a staged backend (make_backend(..., "
                "staged=True)): the pull must consume working-set rows, "
                "not a resident table")
        if self.store.kind != "disk" and staged:
            raise ValueError(
                "staged backend requires store='disk': nothing stages the "
                "working-set rows under the host store")
        # per-table (uids, valid) of the batch currently staged: what the
        # gather placement's absorb commits its pushed rows by
        self._staged_pending: Dict[str, Any] = {}
        # pinned host buffers of the staged copies, one per tensor per
        # stage, each with the event of the last upload that read it
        self._pinned: Dict[Any, Any] = {}
        self._side: Optional["torch.cuda.Stream"] = None   # pull_async's

    # ------------------------------------------------------------ lifecycle
    def init(self, generator: torch.Generator,
             scale: float = 0.01) -> Dict[str, torch.Tensor]:
        """Random-normal logical init (tables in name order, drawn one after
        the other from ``generator``, which must live on the engine's
        device), converted to the backend's layout.

        Under the DiskStore the same drawn values go to the store's page
        files (with the optimizer's initial accumulator), and the returned
        "tables" are the ``(capacity, dim)`` staging buffers the pull and
        push thread instead."""
        tables = {}
        for name, spec in sorted(self.specs.items()):
            t = torch.empty((spec.rows, spec.dim), dtype=torch.float32,
                            device=self.device)
            t.normal_(generator=generator).mul_(scale)
            t = t.to(spec.dtype)
            if self.store.kind == "disk":
                self.store.create_table(
                    name, spec.rows, spec.dim, _np_dtype(spec.dtype),
                    init_rows_fn=lambda a, b, _t=t: _t[a:b].cpu().numpy(),
                    accum_init=self.opt.cfg.initial_accumulator)
                tables[name] = torch.zeros((self.capacity, spec.dim),
                                           dtype=spec.dtype,
                                           device=self.device)
            else:
                tables[name] = self.backend.prepare(t)
        return tables

    def init_state(self, tables: Dict[str, torch.Tensor]) -> SparseAdagradState:
        return self.opt.init(tables)

    def init_backend_state(self, tables: Dict[str, torch.Tensor]):
        """Per-table backend state (empty tuples when stateless)."""
        return {n: self.backend.init_state(t) for n, t in tables.items()}

    def prepare(self, tables: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Logical tables -> the backend's layout and placement (the cached
        placement keeps them in host memory)."""
        return {n: self.backend.prepare(t) for n, t in tables.items()}

    def export(self, tables: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Backend layout -> logical rows (row i == feature id i).  Under
        the cached placement, ``flush`` first so the dirty cached rows reach
        the tables."""
        return {n: self.backend.export(t) for n, t in tables.items()}

    def flush(self, tables, accum, states):
        """Force the backend's deferred writes (dirty cached rows) into the
        tables and the accumulator: ``(tables, accum, states)``."""
        new_tables, new_accum, new_states = {}, {}, {}
        for name in tables:
            nt, na, ns = self.backend.flush(tables[name], accum[name],
                                            states[name])
            new_tables[name], new_accum[name], new_states[name] = nt, na, ns
        return new_tables, new_accum, new_states

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
    def plan(self, flat_ids: Dict[str, torch.Tensor],
             host_ids: Optional[Dict[str, np.ndarray]] = None) -> PullPlan:
        """The ids-only part of a pull (``PullPlan``): each table's backend
        plan and, on the DiskStore, its host dedup of ``host_ids`` (the
        batch's flat ids on the host; None: copied back from
        ``flat_ids``).  Reads no table and no backend state."""
        host = None
        if self.store.kind == "disk":
            if host_ids is None:
                host_ids = self._ids_to_host(flat_ids)
            host = {n: self.host_dedup(x) for n, x in host_ids.items()}
        return PullPlan({n: self.backend.plan(ids, self.capacity)
                         for n, ids in flat_ids.items()}, host)

    def pull(self, tables, accum, states, flat_ids: Dict[str, torch.Tensor],
             plan: Optional[PullPlan] = None):
        """Algorithm 1 line 3: one working-set pull per table.  Returns
        ``(working_sets, tables, accum, states)``.  ``plan``: the batch's
        ``PullPlan``, each table's computed in its pull when None."""
        wss, new_tables, new_accum, new_states = {}, {}, {}, {}
        for name, ids in flat_ids.items():
            ws, nt, na, ns = self.backend.pull(
                tables[name], accum[name], states[name], ids, self.capacity,
                plan=None if plan is None else plan.device[name])
            wss[name] = ws
            new_tables[name], new_accum[name], new_states[name] = nt, na, ns
        return wss, new_tables, new_accum, new_states

    def pull_batch(self, tables, accum, states, batch):
        return self.pull(tables, accum, states, self.ids_from_batch(batch))

    def pull_stage(self):
        """The PULL stage ``(tables, accum, states, flat_ids) -> (wss,
        tables, accum, states)``.  PyTorch runs eagerly, so the stage is
        ``pull`` itself; under the DiskStore, ``pull`` wrapped in the
        staging protocol (``disk_pull``)."""
        return self.disk_pull if self.store.kind == "disk" else self.pull

    @staticmethod
    def commit(pulled):
        """Hand a pull's ``(wss, tables, accum, states)`` to the train stage
        (the serialization point of the reference's prefetch protocol; with
        eager, synchronous pulls nothing happens here)."""
        return pulled

    def _side_stream(self):
        """The plan's side stream on the card (made once); None on the
        CPU."""
        if self.device.type != "cuda":
            return None
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def pull_async(self, tables, accum, states, batch, stage):
        """Issue ``batch``'s pull ahead of its step (the prefetch protocol,
        see the module docstring).  ``stage`` puts the caller's batch on
        the device (on the card it runs on the side stream, so the copy
        waits for nothing queued on the main stream).  Returns ``(wss,
        tables, accum, states, staged_batch, event)``: ``event`` (None on
        the CPU) is recorded on the side stream after the plan, and the
        main stream already waits on it."""
        side = self._side_stream()
        with (torch.cuda.stream(side) if side is not None
              else contextlib.nullcontext()):
            staged = stage(batch)
            flat = self.ids_from_batch(staged)
            host_ids = None
            if self.store.kind == "disk" and not any(
                    torch.is_tensor(v) and v.is_cuda for v in batch.values()):
                # the ids from the host batch: no copy back from the card
                host_ids = {n: x.numpy() for n, x in self.ids_from_batch(
                    {k: torch.as_tensor(np.asarray(v))
                     for k, v in batch.items()}).items()}
            plan = self.plan(flat, host_ids)
            event = None
            if side is not None:
                event = torch.cuda.Event()
                event.record(side)
        if side is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(event)
            # made on the side stream, used on the main one: their blocks
            # stay theirs until the main stream's work on them is done
            tree_map(lambda t: t.record_stream(main),
                     (staged, flat, plan.device))
        stage_fn = self.disk_pull if self.store.kind == "disk" else self.pull
        wss, tables, accum, states = stage_fn(tables, accum, states, flat,
                                              plan)
        return wss, tables, accum, states, staged, event

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
        aux)``.  PyTorch runs eagerly, so the stage is ``lookup`` itself
        (under the DiskStore wrapped in ``stage_lookup``); it consumes none
        of the live training tensors."""
        return self.disk_lookup if self.store.kind == "disk" else self.lookup

    # ----------------------------------------------- disk-store staging path
    def host_dedup(self, ids_np: np.ndarray):
        """Numpy mirror of the device dedup's uid layout, run at staging
        time: sorted ascending unique, truncated to the capacity keeping
        the smallest, padded by repeating the minimum.  ``valid`` marks
        first occurrences (pads repeat an earlier value, so a strict >
        test finds them): only valid positions commit back to the store,
        because a last-wins scatter would let pad rows overwrite real
        updates."""
        cap = self.capacity
        u = np.unique(np.asarray(ids_np, np.int64).reshape(-1))
        k = min(len(u), cap)
        uids = np.full((cap,), u[0], np.int64)
        uids[:k] = u[:k]
        valid = np.ones((cap,), bool)
        valid[1:] = uids[1:] > uids[:-1]
        return uids, valid

    def _is_cached(self) -> bool:
        return getattr(self.backend, "cache_rows", None) is not None

    def _pinned_buffer(self, key, shape, dtype) -> torch.Tensor:
        """A pinned host buffer made once per ``key`` (one per tensor per
        stage), outside inference mode so training may write into a buffer
        serving made first.  Before the host writes into it again, the
        last upload that read it has finished (``_upload`` records it)."""
        ent = self._pinned.get(key)
        if ent is None or tuple(ent[0].shape) != tuple(shape):
            with torch.inference_mode(False):
                buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            ent = [buf, None]
            self._pinned[key] = ent
        elif ent[1] is not None:
            ent[1].synchronize()
            ent[1] = None
        return ent[0]

    def _to_host(self, key, t: torch.Tensor) -> np.ndarray:
        """``t`` as a numpy array (a blocking device-to-host copy into a
        pinned buffer on the card; a view on the CPU).  The caller copies
        what it keeps before the buffer's next use."""
        if t.device.type == "cpu":
            return t.numpy()
        buf = self._pinned_buffer(key, t.shape, t.dtype)
        buf.copy_(t)
        return buf.numpy()

    def _ids_to_host(self, flat_ids) -> Dict[str, np.ndarray]:
        """The batch's flat ids on the host (the staged path's first
        device-to-host copy)."""
        return {n: ids.cpu().numpy() for n, ids in flat_ids.items()}

    def read_staged(self, ded, stage: str = "pull", overlay=None):
        """``{name: (rows, accum)}``: the store's rows of each table's
        deduplicated uids as host tensors (on the card pinned buffers, one
        per tensor per stage), read with ``serve=True`` for ``stage ==
        "lookup"``, with ``overlay`` (``{name: (uids, rows, accum)}``, see
        ``_staged_updates``) patched over them."""
        out = {}
        serve = stage == "lookup"
        for n, (uids, valid) in ded.items():
            spec = self.specs[n]
            if self.device.type == "cpu":
                rows, acc = self.store.gather(n, uids, serve=serve)
                host = torch.from_numpy(rows), torch.from_numpy(acc)
            else:
                shape = (len(uids), spec.dim)
                host = (self._pinned_buffer((stage, n, "rows"), shape,
                                            spec.dtype),
                        self._pinned_buffer((stage, n, "accum"), shape,
                                            torch.float32))
                rows, acc = self.store.gather(
                    n, uids, serve=serve,
                    out=(host[0].numpy(), host[1].numpy()))
            if overlay is not None and n in overlay:
                o_uid, o_rows, o_acc = overlay[n]
                k = int(valid.sum())     # uids[:k] is sorted unique
                pos = np.searchsorted(uids[:k], o_uid)
                hit = pos < k
                hit[hit] = uids[pos[hit]] == o_uid[hit]
                rows[pos[hit]] = o_rows[hit].astype(rows.dtype, copy=False)
                acc[pos[hit]] = o_acc[hit]
            out[n] = host
        return out

    def upload_staged(self, host, stage: str = "pull"):
        """``read_staged``'s host rows on the engine's device:
        ``(staged_tables, staged_accum)`` (non-blocking copies from the
        pinned buffers on the card; the tensors themselves on the CPU)."""
        staged_t, staged_a = {}, {}
        for n, (rows, acc) in host.items():
            if self.device.type == "cpu":
                staged_t[n], staged_a[n] = rows, acc
            else:
                staged_t[n] = self._upload((stage, n, "rows"), rows)
                staged_a[n] = self._upload((stage, n, "accum"), acc)
        return staged_t, staged_a

    def _upload(self, key, buf: torch.Tensor) -> torch.Tensor:
        out = buf.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._pinned[key][1] = ev
        return out

    def _staged_updates(self, tables, accum, states):
        """Pending staged training outputs as ``{name: (uids, rows,
        accum)}`` numpy triples: the rows the DiskStore does not hold yet.

        cached: the pull's table/accum OUTPUTS are the evicted dirty rows,
        ids in ``state.spill_uid`` (-1 = no spill).  gather: the push's
        outputs are the updated staged rows of the batch recorded in
        ``_staged_pending``, committed at its valid positions.  READ-ONLY:
        shared by ``absorb_staged`` (which scatters the triples into the
        store and clears the pending record) and the serving lookup's
        overlay (which patches them onto store reads, committing nothing).
        The device-to-host copy waits for the step that wrote them."""
        out: Dict[str, Any] = {}
        if self._is_cached():
            for n in self.specs:
                uid = self._to_host(("d2h", n, "uid"),
                                    states[n].spill_uid).copy()
                m = uid >= 0
                if m.any():
                    rows = self._to_host(("d2h", n, "rows"), tables[n])
                    acc = self._to_host(("d2h", n, "accum"), accum[n])
                    out[n] = (uid[m], rows[m], acc[m])
        else:
            for n, (uids, valid) in self._staged_pending.items():
                rows = self._to_host(("d2h", n, "rows"), tables[n])
                acc = self._to_host(("d2h", n, "accum"), accum[n])
                out[n] = (uids[valid], rows[valid], acc[valid])
        return out

    def absorb_staged(self, tables, accum, states):
        """Commit the previous step's staged outputs into the DiskStore.
        The writes are of absolute row values, so absorbing again is
        idempotent (which is also why the serving lookup may overlay the
        same triples while they sit un-absorbed)."""
        for n, (uids, rows, acc) in self._staged_updates(
                tables, accum, states).items():
            self.store.scatter(n, uids, rows, acc)
        self._staged_pending = {}

    def disk_pull(self, tables, accum, states, flat_ids,
                  plan: Optional[PullPlan] = None):
        """The DiskStore pull stage: host dedup -> ``readahead`` ->
        ``absorb_staged`` (the previous step's outputs) -> ``gather`` into
        pinned buffers -> upload -> the backend's staged pull.  Returns
        ``(wss, tables, accum, states)`` as ``pull`` does.  ``plan``: the
        batch's ``PullPlan`` (its host dedup and the backend's plans),
        computed here when None."""
        ded = (plan.host if plan is not None else
               {n: self.host_dedup(x)
                for n, x in self._ids_to_host(flat_ids).items()})
        for n, (uids, valid) in ded.items():
            self.store.readahead(n, uids[valid])
        self.absorb_staged(tables, accum, states)
        staged_t, staged_a = self.upload_staged(self.read_staged(ded))
        self._staged_pending = ded
        return self.pull(staged_t, staged_a, states, flat_ids, plan)

    def stage_lookup(self, tables, accum, states,
                     ids_np: Dict[str, np.ndarray]):
        """Read-only staging of a lookup batch's rows from the DiskStore:
        ``(staged_tables, staged_accum)``, ``(capacity, dim)`` device
        buffers in deduplicated-uid order, shaped like the training
        staging buffers.  It NEVER writes the store: pages are read with
        ``serve=True`` (serve-metered, no read-ahead), and the pending
        staged training outputs are OVERLAID onto the gathered rows on the
        host, so the freshest values are served without absorbing the
        training side's commit."""
        overlay = self._staged_updates(tables, accum, states)
        ded = {n: self.host_dedup(ids) for n, ids in ids_np.items()}
        return self.upload_staged(self.read_staged(ded, "lookup", overlay),
                                  "lookup")

    def disk_lookup(self, tables, accum, states, flat_ids):
        """The DiskStore lookup stage: ``stage_lookup`` then the backend's
        staged lookup, ``(wss, aux)``."""
        staged_t, staged_a = self.stage_lookup(
            tables, accum, states, self._ids_to_host(flat_ids))
        return self.lookup(staged_t, staged_a, states, flat_ids)

    def sync_store(self, tables, accum, states):
        """DiskStore commit point: absorb the pending staged outputs, write
        the device cache's dirty rows through, and persist every dirty
        page.  Leaves device state untouched (dirty bits stay set: the next
        sync writes the same values again, which is idempotent).  No-op
        under the host store."""
        if self.store.kind != "disk":
            return
        self.absorb_staged(tables, accum, states)
        if self._is_cached():
            for n in self.specs:
                st = states[n]
                m = (st.dirty & (st.slot_uid >= 0)).cpu().numpy()
                if m.any():
                    idx = torch.from_numpy(np.flatnonzero(m)).to(
                        st.slot_uid.device)
                    self.store.scatter(
                        n, st.slot_uid[idx].cpu().numpy(),
                        st.rows[idx].cpu().numpy(),
                        st.accum[idx].cpu().numpy())
        self.store.flush()

    def reset_staging(self):
        """Drop the pending staged-batch record (a resume: the restored
        pages hold everything committed at save)."""
        self._staged_pending = {}

    def cache_counters(self, states) -> Dict[str, float]:
        """The cache tier's CUMULATIVE counters summed across tables ({} for
        stateless placements), read to the host.  Per-interval deltas are
        the trainer's job."""
        tot: Dict[str, float] = {}
        stats_fn = getattr(self.backend, "stats", None)
        if stats_fn is not None:
            for s in states.values():
                for k, v in stats_fn(s).items():
                    tot[k] = tot.get(k, 0.0) + v
        for k, v in self.store.stats().items():
            tot[k] = tot.get(k, 0.0) + float(v)
        return tot

    @staticmethod
    def derive_cache_stats(counters: Dict[str, float]) -> Dict[str, float]:
        """Counter totals or deltas -> the reported stats ({} for {}).  An
        interval with no lookups reports ``cache_hit_rate`` 0.0, not 1.0.
        Under the DiskStore the page tier's meters ride along
        (``page_hit_rate``, ``pages_evicted``, ``disk_bytes_read``,
        ``disk_bytes_written``)."""
        if not counters:
            return {}
        out: Dict[str, float] = {}
        if "lookups" in counters:
            lookups = counters["lookups"]
            hit_rate = (
                0.0 if lookups <= 0.0 else 1.0 - counters["fetched"] / lookups
            )
            out.update({
                "cache_hit_rate": hit_rate,
                "evictions": int(counters["evictions"]),
                "cache_bytes_h2d": counters["bytes_h2d"],
                "cache_bytes_d2h": counters["bytes_d2h"],
            })
        if "page_hits" in counters:
            touches = counters["page_hits"] + counters["page_misses"]
            out.update({
                "page_hit_rate": (
                    0.0 if touches <= 0.0 else counters["page_hits"] / touches
                ),
                "pages_evicted": int(counters["pages_evicted"]),
                "disk_bytes_read": counters["disk_bytes_read"],
                "disk_bytes_written": counters["disk_bytes_written"],
            })
        return out

    def cache_stats(self, states) -> Dict[str, float]:
        """Whole-run cache stats ({} for stateless placements)."""
        return self.derive_cache_stats(self.cache_counters(states))

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


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (the store's pages are numpy)."""
    return torch.empty((0,), dtype=dtype).numpy().dtype
