"""The cached placement: a device cache over a host-resident table.

Counterpart of ``repro/core/cache_tier.py`` (the paper's §2.3 parameter
hierarchy).  CTR traffic is Zipf-skewed, so a small device cache holding
the hot rows serves almost every pull, and the full table never has to be
on the card:

  - the FULL table and its AdaGrad accumulator stay in host memory, as CPU
    tensors (``prepare`` moves them there);
  - the ``CacheState`` lives on the card: ``cache_rows`` slots of rows and
    accumulator rows, the id -> slot linear-probe hash map
    (``kernels.hash_map``, O(cache_rows)), per-slot LFU counters, dirty
    bits, and the byte and event meters.

Per pull, as in the reference:
  1. dedup the batch's ids (``plan``: the ids-only part, which a
     prefetcher runs ahead on a side stream) and probe each in the hash
     map (the CUDA probe);
  2. LFU with decay: the coldest slots not hit by this batch become the
     victims, empty slots first (a stable sort breaks ties by the lower
     slot, as the reference's ``top_k`` does); evicted dirty rows spill
     (value + accumulator) to the host table;
  3. the misses' rows come up from the host table, are admitted into the
     victims' slots, and the hash map takes the new (id, slot) pairs; it is
     rebuilt from ``slot_uid`` first when stale entries would push its
     occupancy past 3H/4;
  4. the working rows are gathered from the cache by slot, the working
     set's zero drop row after them (one launch of the CUDA cached
     gather).

``push`` writes the AdaGrad update through to the cache only (the CUDA
cached push, which reads the accumulator rows and does the row math
itself) and marks the slots dirty; ``flush`` writes every dirty row
back.

Staged (the DiskStore, ``staged=True``): the pull's ``table``/``accum`` are
the batch's ``(capacity, dim)`` working-set rows in uid order, staged by the
engine from the store, and a miss takes its row from its own position;
evicted dirty rows leave through the pull's table/accum OUTPUTS (ids in
``state.spill_uid``, -1 where none) for the engine to commit to the store
at the next step; ``flush`` only clears the dirty bits (the engine writes
the rows, ``sync_store``).  ``lookup`` is the read-only serving path: hits from the cache,
misses from the host table, nothing admitted and nothing counted in the
state.  With ``cache_rows >= table rows`` nothing is ever evicted and the
placement is bit-identical to the gather placement.

Host <-> device traffic: on the card, only the rows that move cross the
bus, through pinned ``(capacity, dim)`` staging buffers (the misses up, the
spilled rows down; ``lookup`` reads only its misses).  Every host write
into a staging buffer follows a blocking device-to-host copy on the same
stream, so the previous upload from it has finished.  On the CPU
everything lies on the CPU and nothing is staged.

The port updates every tensor of the cache state, the table and the
accumulator in place (the counterpart of the reference's buffer donation);
``pull``, ``push`` and ``flush`` return the same objects, as the
reference's return its new state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.embedding_backend import WorkingSet, _dedup
from repro_torch.kernels import ops
from repro_torch.kernels.hash_map import (
    hash_insert,
    hash_rebuild,
    hash_table_size,
)


class CacheState(NamedTuple):
    """The device cache of ONE table, with the reference's fields.

    An entry ``(k, s)`` of the hash map is live iff ``slot_uid[s] == k``.
    A "lookup" is one (non-dropped) id slot served by a pull; a fetched row
    serves every duplicate of its id in the batch, so
    ``hit_rate = 1 - fetched / lookups``.  The counters are f32 scalars.
    ``spill_uid`` is the staged (DiskStore) mode's: the evicted dirty ids
    whose rows ride out through the pull's outputs, -1 where none,
    ``(capacity,)``; the host mode keeps it 0-sized.
    """

    slot_uid: torch.Tensor    # (C,) int32: the id held by each slot; -1 empty
    key_tab: torch.Tensor     # (H,) int32: hash bucket keys; -1 EMPTY
    slot_tab: torch.Tensor    # (H,) int32: hash bucket values (cache slots)
    n_occupied: torch.Tensor  # () int32: occupied buckets, stale included
    rows: torch.Tensor        # (C, dim): cached row values
    accum: torch.Tensor       # (C, dim) f32: cached AdaGrad accumulator rows
    freq: torch.Tensor        # (C,) f32: LFU-with-decay counters
    dirty: torch.Tensor       # (C,) bool: row updated since admission
    spill_uid: torch.Tensor   # (capacity,) int32 staged; (0,) host mode
    lookups: torch.Tensor     # () f32: id slots served
    fetched: torch.Tensor     # () f32: rows fetched from the host (misses)
    evictions: torch.Tensor   # () f32: occupied slots reassigned
    rebuilds: torch.Tensor    # () f32: hash-map occupancy rebuilds
    bytes_h2d: torch.Tensor   # () f32: host -> device fetch traffic
    bytes_d2h: torch.Tensor   # () f32: device -> host spill traffic


_COUNTERS = ("lookups", "fetched", "evictions", "rebuilds", "bytes_h2d",
             "bytes_d2h")


def _unique_positions(uids: torch.Tensor) -> torch.Tensor:
    """True at each unique id of a working set (its pads repeat uids[0])."""
    return torch.cat([torch.ones((1,), dtype=torch.bool, device=uids.device),
                      uids[1:] > uids[:-1]])


def _multiplicity(inverse: torch.Tensor, capacity: int) -> torch.Tensor:
    """Per-position count of the batch's id slots (f32, whole numbers);
    the dropped slots, which point at ``capacity``, are not counted."""
    return torch.bincount(inverse.long(), minlength=capacity + 1)[
        :capacity].to(torch.float32)


class CachedBackend:
    """Hot/cold placement: a device cache over a host-resident table.

    Parameters
    ----------
    cache_rows: the cache size C in rows; must cover the pull capacity (one
        batch's working set must fit).  ``cache_rows >= table rows`` is a
        full mirror, bit-identical to ``GatherBackend``.
    decay: the multiplicative LFU decay per pull (1.0 = plain LFU).
    device: where the cache state lives (CUDA unless the caller asks for
        the CPU); the table and the accumulator live in host memory (or,
        staged, in the DiskStore's pages).
    staged: the DiskStore mode (see the module docstring); requires
        ``capacity``, the pull capacity, which sizes ``spill_uid``.
    """

    def __init__(self, cache_rows: int, decay: float = 0.95, device="cuda",
                 staged: bool = False, capacity: Optional[int] = None):
        if cache_rows <= 0:
            raise ValueError(f"cache_rows must be positive, got {cache_rows}")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if staged and not capacity:
            raise ValueError("staged CachedBackend requires capacity "
                             "(sizes the per-pull spill buffers)")
        self.staged = bool(staged)
        self.capacity = int(capacity) if capacity else None
        self.device = resolve_device(device)
        self.cache_rows = int(cache_rows)
        self.decay = float(decay)
        self.hash_buckets = hash_table_size(self.cache_rows)
        self._staging = {}

    # -------------------------------------------------------------- layout
    def prepare(self, table: torch.Tensor) -> torch.Tensor:
        """The cold tier lives in host memory: the table as a CPU tensor
        (staged: the staging buffers stay where they are)."""
        return table if self.staged else table.cpu()

    def export(self, table: torch.Tensor) -> torch.Tensor:
        return table

    def init_state(self, table: torch.Tensor) -> CacheState:
        C, H, dim = self.cache_rows, self.hash_buckets, table.shape[1]
        dev = self.device

        def z():
            return torch.zeros((), dtype=torch.float32, device=dev)

        return CacheState(
            slot_uid=torch.full((C,), -1, dtype=torch.int32, device=dev),
            key_tab=torch.full((H,), -1, dtype=torch.int32, device=dev),
            slot_tab=torch.zeros((H,), dtype=torch.int32, device=dev),
            n_occupied=torch.zeros((), dtype=torch.int32, device=dev),
            rows=torch.zeros((C, dim), dtype=table.dtype, device=dev),
            accum=torch.zeros((C, dim), dtype=torch.float32, device=dev),
            freq=torch.zeros((C,), dtype=torch.float32, device=dev),
            dirty=torch.zeros((C,), dtype=torch.bool, device=dev),
            spill_uid=torch.full((self.capacity if self.staged else 0,), -1,
                                 dtype=torch.int32, device=dev),
            lookups=z(), fetched=z(), evictions=z(), rebuilds=z(),
            bytes_h2d=z(), bytes_d2h=z(),
        )

    @staticmethod
    def _row_bytes(table: torch.Tensor) -> int:
        # one row moved = the value row + its f32 accumulator row
        return table.shape[1] * (table.element_size() + 4)

    # ----------------------------------------------------- host <-> device
    def _stage(self, i: int, like: torch.Tensor,
               capacity: int) -> torch.Tensor:
        """Pinned (capacity, dim) buffer ``i`` of ``like``'s dtype, made
        once: one per tensor moved together (rows, accumulator rows), since
        an upload from one may still be in flight while the host fills the
        next.  Made outside inference mode, so training may write into a
        buffer that serving created first."""
        key = (i, like.dtype, like.shape[1], capacity)
        buf = self._staging.get(key)
        if buf is None:
            with torch.inference_mode(False):
                buf = torch.empty((capacity, like.shape[1]),
                                  dtype=like.dtype, pin_memory=True)
            self._staging[key] = buf
        return buf

    def _fetch(self, host, ids, capacity: int):
        """``host[ids]`` (each a CPU tensor) on the cache's device."""
        if host[0].device == self.device:
            return [h.index_select(0, ids.long()) for h in host]
        ids_h = ids.cpu().long()
        out = []
        for i, h in enumerate(host):
            buf = self._stage(i, h, capacity)[:ids_h.numel()]
            torch.index_select(h, 0, ids_h, out=buf)
            out.append(buf.to(self.device, non_blocking=True))
        return out

    def _spill(self, host, ids, rows, capacity: int) -> None:
        """``host[ids] = rows`` for each (CPU tensor, device rows) pair."""
        if host[0].device == self.device:
            for h, r in zip(host, rows):
                h.index_copy_(0, ids.long(), r.to(h.dtype))
            return
        ids_h = ids.cpu().long()
        for i, (h, r) in enumerate(zip(host, rows)):
            buf = self._stage(i, h, capacity)[:ids_h.numel()]
            buf.copy_(r)                    # blocking device -> host copy
            h.index_copy_(0, ids_h, buf)

    # ---------------------------------------------------------------- pull
    @staticmethod
    def plan(flat_ids, capacity: int):
        """The ids-only part of a pull or a lookup, which reads no table and
        no cache state: ``(uids, inverse, n_dropped, valid, counts)``, the
        dedup, its unique positions and each position's multiplicity."""
        uids, inverse, n_dropped = _dedup(flat_ids, capacity)
        return (uids, inverse, n_dropped, _unique_positions(uids),
                _multiplicity(inverse, capacity))

    def pull(self, table, accum, state: CacheState, flat_ids, capacity: int,
             plan=None):
        """Training pull: ``(WorkingSet, table, accum, state)``.  ``plan``:
        ``self.plan(flat_ids, capacity)``, computed here when None."""
        C = self.cache_rows
        if C < capacity:
            raise ValueError(
                f"cache_rows ({C}) must cover the pull capacity ({capacity}): "
                f"one batch's working set must fit in the device cache"
            )
        self._check_staged(table, capacity, "pull")
        H = self.hash_buckets
        uids, inverse, n_dropped, valid, counts = (
            self.plan(flat_ids, capacity) if plan is None else plan)

        # rebuild the map from slot_uid before stale entries can push its
        # occupancy past 3H/4 (every chain keeps an EMPTY bucket)
        need_rebuild = int(state.n_occupied) + capacity > (3 * H) // 4
        if need_rebuild:
            for old, new in zip((state.key_tab, state.slot_tab,
                                 state.n_occupied),
                                hash_rebuild(state.slot_uid, H)):
                old.copy_(new)

        slot = ops.hash_lookup(state.key_tab, state.slot_tab,
                               state.slot_uid, uids)
        hit = valid & (slot >= 0)
        miss = valid & (slot < 0)
        n_miss = miss.sum(dtype=torch.int32)

        # LFU with decay: empty slots first, then the coldest; the slots hit
        # by this batch are never evicted
        freq = state.freq.mul_(self.decay)
        score = torch.where(state.slot_uid < 0, -1.0, freq)
        protected = torch.zeros((C,), dtype=torch.bool, device=score.device)
        protected[slot[hit].long()] = True
        score = torch.where(protected, float("inf"), score)
        victims = torch.sort(-score, descending=True, stable=True).indices[
            :capacity]
        used = torch.arange(capacity, device=victims.device) < n_miss
        v_old = state.slot_uid[victims]
        evict = used & (v_old >= 0)
        spill = evict & state.dirty[victims]

        if self.staged:
            # the evicted rows leave through the pull's outputs, the dirty
            # ones marked by spill_uid; the engine commits them to the store
            state.spill_uid.copy_(torch.where(spill, v_old, -1))
            out_table = state.rows[victims].to(table.dtype)
            out_accum = state.accum[victims]
        else:
            # spill the evicted dirty rows to the host table
            sp = torch.nonzero(spill).reshape(-1)
            if sp.numel():
                sv = victims[sp]
                self._spill((table, accum), v_old[sp],
                            (state.rows[sv], state.accum[sv]), capacity)
            out_table, out_accum = table, accum

        # fetch the misses from the cold tier in one gather (staged: the
        # rows at their own positions) and admit them
        miss_rank = torch.cumsum(miss, 0) - 1
        target = torch.where(
            miss, victims[torch.clamp(miss_rank, 0, capacity - 1)], C).to(
            torch.int32)
        mp = torch.nonzero(miss).reshape(-1)
        if mp.numel():
            m_ids, m_slots = uids[mp], target[mp].long()
            if self.staged:
                f_rows, f_accum = table[mp], accum[mp]
            else:
                f_rows, f_accum = self._fetch((table, accum), m_ids,
                                              capacity)
            state.slot_uid[m_slots] = m_ids
            state.rows[m_slots] = f_rows.to(state.rows.dtype)
            state.accum[m_slots] = f_accum
            state.dirty[m_slots] = False
            freq[m_slots] = 0.0
        _, _, n_occ = hash_insert(state.key_tab, state.slot_tab,
                                  state.n_occupied, uids, target, miss)
        state.n_occupied.copy_(n_occ)
        # every working-set id is cached now: hits keep their slot, misses
        # took their victim's, and the pads share the first position's
        slot0 = torch.where(miss[0], target[0], slot[0])
        slot_now = torch.where(valid, torch.where(miss, target, slot),
                               slot0).contiguous()
        freq.index_add_(0, slot_now.long(), counts)

        wrows = ops.gather_rows_cached(state.rows, slot_now, drop_row=True)
        rb = self._row_bytes(table)
        n_miss_f = n_miss.to(torch.float32)
        state.lookups.add_(counts.sum())
        state.fetched.add_(n_miss_f)
        state.evictions.add_(evict.sum(dtype=torch.float32))
        state.rebuilds.add_(float(need_rebuild))
        state.bytes_h2d.add_(n_miss_f * rb)
        state.bytes_d2h.add_(spill.sum(dtype=torch.float32) * rb)
        ws = WorkingSet(uids, inverse, wrows, n_dropped)
        return ws, out_table, out_accum, state

    def _check_staged(self, table, capacity: int, what: str) -> None:
        if self.staged and table.shape[0] != capacity:
            raise ValueError(
                f"staged {what} expects ({capacity}, dim) working-set rows "
                f"from the RowStore, got {tuple(table.shape)}")

    # -------------------------------------------------------------- lookup
    def lookup(self, table, accum, state: CacheState, flat_ids,
               capacity: int, plan=None):
        """Read-only serving lookup: ``(WorkingSet, aux)``.

        Probes like ``pull`` and admits nothing: hits come from the cached
        rows (the freshest values: the push writes through to the cache),
        misses from the cold tier (the host table, or staged the
        uid-aligned rows the engine staged with the pending spills laid
        over them), which holds their latest values (an evicted dirty row
        was spilled before its entry died).  Nothing in
        the state changes, so training is the same with or without it;
        ``aux`` meters the served id slots and the misses."""
        C = self.cache_rows
        if C < capacity:
            raise ValueError(
                f"cache_rows ({C}) must cover the lookup capacity "
                f"({capacity}): one batch's working set must fit in the "
                f"device cache"
            )
        self._check_staged(table, capacity, "lookup")
        uids, inverse, n_dropped, valid, counts = (
            self.plan(flat_ids, capacity) if plan is None else plan)
        slot = ops.hash_lookup(state.key_tab, state.slot_tab,
                               state.slot_uid, uids)
        hit = slot >= 0
        safe = torch.where(hit, slot, 0).contiguous()
        wrows = ops.gather_rows_cached(state.rows, safe, drop_row=True)
        mp = torch.nonzero(~hit).reshape(-1)
        if mp.numel():
            if self.staged:
                cold = table[mp]
            else:
                (cold,) = self._fetch((table,), uids[mp], capacity)
            wrows[mp] = cold.to(wrows.dtype)
        ws = WorkingSet(uids, inverse, wrows, n_dropped)
        aux = {
            "serve_lookups": counts.sum(),
            "serve_misses": (valid & ~hit).sum(dtype=torch.float32),
        }
        return ws, aux

    # ---------------------------------------------------------------- push
    def push(self, table, accum, state: CacheState, ws: WorkingSet,
             row_grads, opt):
        """Write-through to the CACHE only (the host table sees the update
        at spill or flush time): the same AdaGrad row math as the gather
        placement, applied to the cached rows by slot, in place."""
        uids = ws.uids
        # every working-set id is live in the map after the matching pull
        slot = ops.hash_lookup(state.key_tab, state.slot_tab,
                               state.slot_uid, uids)
        grads = row_grads[: uids.shape[0]]
        ops.sparse_adagrad_cached_apply(
            state.rows, state.accum, slot, grads, lr=opt.cfg.lr,
            eps=opt.cfg.eps, uids=uids)
        state.dirty[slot.long()] = True
        return table, accum, state

    def flush(self, table, accum, state: CacheState):
        """Write every dirty cached row (value + accumulator) back to the
        host table and clear the dirty bits: the export consistency point.
        Staged, the engine writes the dirty rows to the store itself
        (``EmbeddingEngine.sync_store``, before this); here only the dirty
        bits clear and the spill meter advances."""
        dirty_occ = state.dirty & (state.slot_uid >= 0)
        idx = torch.nonzero(dirty_occ).reshape(-1)
        if idx.numel() and not self.staged:
            ids = state.slot_uid[idx].cpu().long()
            table.index_copy_(0, ids, state.rows[idx].to(table.dtype).cpu())
            accum.index_copy_(0, ids, state.accum[idx].cpu())
        n = dirty_occ.sum(dtype=torch.float32)
        state.dirty.zero_()
        state.bytes_d2h.add_(n * self._row_bytes(table))
        return table, accum, state

    def stats(self, state: CacheState) -> dict:
        """The six counters as Python floats, in one device-to-host copy."""
        vals = torch.stack([getattr(state, k) for k in _COUNTERS]).tolist()
        return dict(zip(_COUNTERS, vals))
