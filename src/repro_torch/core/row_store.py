"""RowStore: where the full tables live, the bottom of the three-level
parameter hierarchy (the paper's §2.3; docs/storage.md).

Counterpart of ``repro/core/row_store.py``, host numpy and threads as
there (a near-literal copy: the port imports nothing of the reference).

``HostStore``
    Resident tables (the default): the tables are whole tensors the engine
    hands to its backend, and the store is a stateless tag.  Where they sit
    is the placement's choice (``backend.prepare``): under the gather
    placement in device memory, under the cached placement in host memory.

``DiskStore``
    The SSD tier.  Per table, the full value table and its AdaGrad
    accumulator live in fixed-size row pages (``page_rows`` rows each) as
    ``page_%06d.npz`` files under ``<spill_dir>/<table>/``, behind an in-RAM
    LRU page cache (``page_cache_pages`` pages; ``None`` = unbounded, the
    full-mirror configuration).  The engine stages each batch's working-set
    rows out of it and commits the pushed rows back
    (``core.embedding_engine``'s staged dataflow).  Three IO disciplines:

    *read-ahead*: ``readahead(uids)`` queues the pages those uids live on
    for a background thread to fault in while the device still trains the
    previous batch, so the blocking ``gather`` finds them warm.

    *write-behind*: ``scatter`` updates pages in the RAM cache and marks
    them dirty; a background writer persists them on LRU eviction or at
    ``flush()``.  A page mid-write is read from an in-flight lookaside copy,
    never from a half-written file.

    *rename-aside page writes*: every page write goes to ``<page>.tmp``
    (+ fsync), then ``os.replace`` onto the final name: a kill mid
    write-behind leaves the old or the new complete page, plus at worst a
    stray ``.tmp`` that ``__init__`` sweeps.

    Background-thread exceptions are captured and re-raised on the next
    API call, so IO errors surface at commit boundaries.

``snapshot_to``/``restore_from`` copy the page set out and back; wiring
them into checkpoint save and resume comes with checkpointing (ROADMAP.md
queue A).
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_PAGE_FMT = "page_%06d.npz"


class HostStore:
    """Resident tables (the default): a stateless placement tag.  The
    engine hands whole tables to its backend; the store participates in
    nothing and meters nothing."""

    kind = "host"

    def close(self):
        pass

    def flush(self):
        pass

    def stats(self) -> dict:
        return {}

    def serve_stats(self) -> dict:
        return {}


class _TableFile:
    """One table's page set under ``<root>/<name>/`` + its dirty/meta state."""

    def __init__(self, root: str, name: str, rows: int, dim: int,
                 dtype: np.dtype, page_rows: int):
        self.dir = os.path.join(root, name)
        self.rows = int(rows)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.page_rows = int(page_rows)
        self.n_pages = -(-self.rows // self.page_rows)  # ceil div
        os.makedirs(self.dir, exist_ok=True)

    def page_path(self, p: int) -> str:
        return os.path.join(self.dir, _PAGE_FMT % p)

    def page_len(self, p: int) -> int:
        """Rows in page p (the last page may be short)."""
        return min(self.page_rows, self.rows - p * self.page_rows)


class DiskStore:
    """Paged spill-directory row store with read-ahead and write-behind.

    Parameters
    ----------
    spill_dir: directory holding one subdirectory of pages per table.
    page_rows: rows per page file.
    page_cache_pages: RAM page-cache capacity in pages across all tables;
        ``None`` = unbounded (every touched page stays resident — the
        full-mirror configuration that is bit-identical to ``HostStore``).
    """

    kind = "disk"

    def __init__(self, spill_dir: str, page_rows: int = 1024,
                 page_cache_pages: Optional[int] = None):
        if page_rows <= 0:
            raise ValueError(f"page_rows must be positive, got {page_rows}")
        if page_cache_pages is not None and page_cache_pages <= 0:
            raise ValueError(
                f"page_cache_pages must be positive or None, "
                f"got {page_cache_pages}")
        self.spill_dir = os.path.abspath(spill_dir)
        self.page_rows = int(page_rows)
        self.page_cache_pages = (
            int(page_cache_pages) if page_cache_pages is not None else None)
        os.makedirs(self.spill_dir, exist_ok=True)
        sweep_stray_tmp(self.spill_dir)

        self._tables: Dict[str, _TableFile] = {}
        self._lock = threading.RLock()
        # page cache: (table, page) -> (rows_arr, accum_arr); LRU via
        # OrderedDict move_to_end; dirty pages tracked separately
        self._cache: "collections.OrderedDict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]]" = (
            collections.OrderedDict())
        self._dirty: set = set()
        # pages handed to the writer thread but not yet on disk: reads hit
        # this lookaside before ever touching the (possibly mid-write) file
        self._in_flight: Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]] = {}
        # per-page mutation generation, bumped under the lock on every
        # dirty-mark and every lookaside retirement: a page fault records
        # the generation before dropping the lock for the file read, and
        # discards the bytes (re-faulting) if it changed on reacquire —
        # the file may have been rewritten mid-read by a racing
        # scatter -> evict -> write-behind, and installing the pre-scatter
        # bytes as a clean page would silently lose that update
        self._page_gen: Dict[Tuple[str, int], int] = {}
        # test/audit seam: called (with the page key) in the fault window,
        # lock released, between the file read and the reacquire
        self._fault_hook = None
        self._bg_error: Optional[BaseException] = None

        self._stats = {
            "page_hits": 0.0, "page_misses": 0.0, "pages_evicted": 0.0,
            "disk_bytes_read": 0.0, "disk_bytes_written": 0.0,
        }
        # serving reads (gather(serve=True)) meter here instead, so the
        # trainer's per-interval page stats stay pure training signal
        self._serve_stats = {
            "page_hits": 0.0, "page_misses": 0.0, "pages_evicted": 0.0,
            "disk_bytes_read": 0.0,
        }

        # workers start LAST: every attribute they touch is published
        # before the first start() (start() is the happens-before edge)
        self._write_q: "queue.Queue" = queue.Queue()
        self._read_q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._writer = threading.Thread(
            target=self._writer_loop, name="diskstore-writer", daemon=True)
        self._reader = threading.Thread(
            target=self._reader_loop, name="diskstore-readahead", daemon=True)
        self._writer.start()
        self._reader.start()

    # ------------------------------------------------------------- lifecycle
    def _check_bg(self):
        with self._lock:
            err, self._bg_error = self._bg_error, None
        if err is not None:
            raise RuntimeError("DiskStore background IO failed") from err

    def close(self):
        """Flush everything and stop the background threads.

        Raises if a worker is still alive after the join timeout — a
        wedged IO thread must be loud (it may be mid page write, leaving
        a ``.tmp`` behind), never silently leaked.
        """
        try:
            self.flush()
        finally:
            self._stop.set()
            self._write_q.put(None)
            self._read_q.put(None)
            self._writer.join(timeout=30)
            self._reader.join(timeout=30)
        wedged = [th.name for th in (self._writer, self._reader)
                  if th.is_alive()]
        if wedged:
            raise RuntimeError(
                f"DiskStore.close: worker thread(s) {wedged} still alive "
                f"after 30s join — IO is wedged and the spill dir may "
                f"hold an in-flight .tmp page")

    # ------------------------------------------------------- table creation
    def create_table(self, name: str, rows: int, dim: int, dtype,
                     init_rows_fn=None, accum_init: float = 0.0,
                     init_accum_fn=None):
        """Register table ``name`` and materialize its pages on disk.

        ``init_rows_fn(start, stop) -> (stop-start, dim)`` generates the
        initial values page by page (so a table larger than RAM never
        materializes whole); ``None`` initializes zeros.  ``accum_init``
        fills the AdaGrad accumulator (``SparseAdagradConfig.
        initial_accumulator``), or ``init_accum_fn(start, stop)`` gives its
        rows (a state loaded from elsewhere).  Existing page files are
        adopted as-is (resume path).
        """
        self._check_bg()
        t = _TableFile(self.spill_dir, name, rows, dim, np.dtype(dtype),
                       self.page_rows)
        with self._lock:
            self._tables[name] = t
        for p in range(t.n_pages):
            path = t.page_path(p)
            if os.path.exists(path):
                continue
            start = p * t.page_rows
            stop = start + t.page_len(p)
            if init_rows_fn is not None:
                vals = np.asarray(init_rows_fn(start, stop), dtype=t.dtype)
            else:
                vals = np.zeros((stop - start, t.dim), t.dtype)
            if init_accum_fn is not None:
                acc = np.asarray(init_accum_fn(start, stop), np.float32)
            else:
                acc = np.full((stop - start, t.dim), accum_init, np.float32)
            _write_page_atomic(path, vals, acc)
            with self._lock:
                self._stats["disk_bytes_written"] += vals.nbytes + acc.nbytes

    def has_table(self, name: str) -> bool:
        with self._lock:
            return name in self._tables

    def table_meta(self, name: str) -> dict:
        t = self._get_table(name)
        return {"rows": t.rows, "dim": t.dim, "dtype": str(t.dtype),
                "page_rows": t.page_rows}

    def _get_table(self, name: str) -> _TableFile:
        # _tables is registered on the main thread but read by the
        # read-ahead worker; every lookup goes through the lock (the
        # _TableFile itself is immutable after construction)
        with self._lock:
            return self._tables[name]

    # ----------------------------------------------------------- page cache
    def _page_apply(self, t: _TableFile, p: int, serve: bool = False,
                    fn=None, dirty: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Run ``fn(vals, acc)`` on page ``p``'s cached arrays under the
        lock, faulting the page in first if needed.

        The critical section never touches the filesystem: a page fault
        releases the lock, reads the file, reacquires, and re-checks — an
        in-flight write-behind copy observed on reacquire wins over the
        file bytes (it is strictly newer, and the file may be
        mid-replace), and file bytes are only installed if the page's
        mutation generation is unchanged from before the read.  The
        generation guard closes the lost-update window the lookaside
        alone cannot: if, during the unlocked read, another thread
        faults + scatters the same page, eviction queues it, AND the
        write-behind completes and retires the lookaside, both the cache
        and the lookaside are empty on reacquire — yet the bytes this
        thread read may predate the scatter.  Dirty-marks and lookaside
        retirements each bump the generation, so that schedule is
        detected and the fault retries against the (now rewritten) file.
        ``dirty=True`` marks the page dirty in the *same* lock hold as
        the mutation, so an eviction can never classify a just-mutated
        page as clean.  ``serve`` selects the meter bucket (training by
        default; the read-only lookup path passes ``serve=True`` so
        inference page traffic never pollutes training-interval stats).
        """
        key = (t.dir, p)
        from_file = None
        first = True
        gen = None
        while True:
            with self._lock:
                stats = self._serve_stats if serve else self._stats
                if (from_file is not None
                        and self._page_gen.get(key, 0) != gen):
                    # the page mutated (or its write-behind landed) while
                    # we read the file: those bytes may be stale — drop
                    # them and re-fault
                    from_file = None
                got = self._cache.get(key)
                if got is not None:
                    self._cache.move_to_end(key)
                    if first:
                        stats["page_hits"] += 1
                else:
                    if first:
                        stats["page_misses"] += 1
                    pending = self._in_flight.get(key)
                    if pending is not None:
                        got = (pending[0].copy(), pending[1].copy())
                    elif from_file is not None:
                        got = from_file
                        stats["disk_bytes_read"] += (
                            got[0].nbytes + got[1].nbytes)
                    if got is not None:
                        self._cache[key] = got
                        self._evict_lru(keep=key, stats=stats)
                if got is not None:
                    if dirty:
                        self._dirty.add(key)
                        self._page_gen[key] = self._page_gen.get(key, 0) + 1
                    if fn is not None:
                        fn(*got)
                    return got
                first = False
                gen = self._page_gen.get(key, 0)
            # page fault: read the file with the lock RELEASED — a miss
            # must not stall the other threads behind SSD latency
            with np.load(t.page_path(p)) as z:
                from_file = (z["rows"], z["accum"])
            hook = self._fault_hook
            if hook is not None:
                hook(key)

    def _evict_lru(self, keep=None, stats: Optional[dict] = None):
        """Shrink the cache to capacity; dirty victims go to the writer."""
        if self.page_cache_pages is None:
            return
        if stats is None:
            stats = self._stats
        while len(self._cache) > self.page_cache_pages:
            for key in self._cache:      # LRU order; skip the pinned page
                if key != keep:
                    break
            else:
                return
            entry = self._cache.pop(key)
            stats["pages_evicted"] += 1
            if key in self._dirty:
                self._dirty.discard(key)
                # the queued tuple IS the lookaside entry: the writer
                # retires the lookaside only if it still holds this exact
                # object (a newer flush may have replaced it)
                self._in_flight[key] = entry
                self._write_q.put((key, entry))

    def _table_of(self, key) -> _TableFile:
        with self._lock:
            tables = list(self._tables.values())
        for t in tables:
            if t.dir == key[0]:
                return t
        raise KeyError(key)

    # ------------------------------------------------------------ access API
    def gather(self, name: str, uids: np.ndarray, serve: bool = False,
               out: Optional[Tuple[np.ndarray, np.ndarray]] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(len(uids), dim) value + accumulator rows, in uid order.

        The blocking read of the pull path: ``readahead`` should have
        warmed the pages while the device trained the previous batch.
        ``serve=True`` is the read-only lookup path: identical reads (and
        identical page-cache warming) metered into ``serve_stats()``, so
        training-interval page stats never count inference traffic.
        ``out``: two (len(uids), dim) arrays to fill (e.g. views of pinned
        staging buffers) instead of new ones.
        """
        self._check_bg()
        t = self._get_table(name)
        uids = np.asarray(uids, np.int64)
        if out is None:
            out_v = np.empty((len(uids), t.dim), t.dtype)
            out_a = np.empty((len(uids), t.dim), np.float32)
        else:
            out_v, out_a = out
            if (out_v.shape != (len(uids), t.dim) or out_v.dtype != t.dtype
                    or out_a.shape != out_v.shape
                    or out_a.dtype != np.float32):
                raise ValueError(
                    f"out must be ({len(uids)}, {t.dim}) {t.dtype} and "
                    f"float32 arrays, got {out_v.shape} {out_v.dtype} and "
                    f"{out_a.shape} {out_a.dtype}")
        for p, sel, r in _page_groups(uids, t.page_rows):

            def copy_out(vals, acc, sel=sel, r=r):
                out_v[sel] = vals[r]
                out_a[sel] = acc[r]

            self._page_apply(t, p, serve=serve, fn=copy_out)
        return out_v, out_a

    def scatter(self, name: str, uids: np.ndarray, rows: np.ndarray,
                accum: np.ndarray):
        """Write value + accumulator rows back (write-behind: RAM pages are
        updated and marked dirty; disk catches up on eviction/flush)."""
        self._check_bg()
        t = self._get_table(name)
        uids = np.asarray(uids, np.int64)
        rows = np.asarray(rows)
        accum = np.asarray(accum)
        for p, sel, r in _page_groups(uids, t.page_rows):

            def write_in(vals, acc, sel=sel, r=r):
                vals[r] = rows[sel].astype(t.dtype, copy=False)
                acc[r] = accum[sel]

            self._page_apply(t, p, fn=write_in, dirty=True)

    def readahead(self, name: str, uids: np.ndarray):
        """Queue the pages holding ``uids`` for background fault-in.

        Non-blocking: the reader thread pulls pages into the cache while
        the device trains, hiding disk latency under the train stage.
        """
        self._check_bg()
        t = self._get_table(name)
        pages = np.unique(np.asarray(uids, np.int64) // t.page_rows)
        with self._lock:
            todo = [int(p) for p in pages if (t.dir, int(p)) not in self._cache]
        for p in todo:
            self._read_q.put((name, p))

    # ------------------------------------------------------------ durability
    def flush(self):
        """Write every dirty page to disk and wait for the writer to drain.

        The durability point: after ``flush`` returns, the page files on
        disk are the complete, current table (checkpoint snapshots and
        parity reads call this first).
        """
        self._check_bg()
        with self._lock:
            dirty = list(self._dirty)
            self._dirty.clear()
            for key in dirty:
                entry = self._cache[key]
                self._in_flight[key] = entry
                self._write_q.put((key, entry))
        self._write_q.join()
        self._check_bg()

    def snapshot_to(self, dest_dir: str):
        """Copy the complete page set into ``dest_dir/<table>/`` (checkpoint
        staging).  Flushes first, then copies page files byte-for-byte —
        the copies inherit the rename-aside crash safety of the enclosing
        checkpoint directory."""
        self.flush()
        for name, t in self._tables.items():
            d = os.path.join(dest_dir, name)
            os.makedirs(d, exist_ok=True)
            for p in range(t.n_pages):
                src = t.page_path(p)
                dst = os.path.join(d, _PAGE_FMT % p)
                _copy_file_atomic(src, dst)

    def restore_from(self, src_dir: str):
        """Replace the live pages with a checkpoint's page set (resume).

        Drops the page cache — restored state must come from the restored
        files, not from stale RAM pages.
        """
        self._check_bg()
        with self._lock:
            self._dirty.clear()
        # drain write-behind AND read-ahead: a stale page write landing
        # AFTER the restore copy — or a read-ahead faulting pre-restore
        # file bytes back into the cache mid-copy — would silently corrupt
        # the resumed state
        self._write_q.join()
        self._read_q.join()
        self._check_bg()
        with self._lock:
            # bump every known page generation: any fault mid-read when
            # the restore starts must discard its pre-restore file bytes
            for key in set(self._cache) | set(self._in_flight):
                self._page_gen[key] = self._page_gen.get(key, 0) + 1
            self._cache.clear()
            self._in_flight.clear()
            tables = list(self._tables.items())
        # copy with the lock released: both queues are drained, the
        # workers are idle, and only this (main) thread faults pages in
        for name, t in tables:
            d = os.path.join(src_dir, name)
            for p in range(t.n_pages):
                src = os.path.join(d, _PAGE_FMT % p)
                if not os.path.exists(src):
                    raise FileNotFoundError(
                        f"checkpoint missing page {src} for table "
                        f"{name!r} — layout mismatch?")
                _copy_file_atomic(src, t.page_path(p))

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def serve_stats(self) -> dict:
        """Cumulative page-tier meters for serving reads only (see
        ``gather(serve=True)``)."""
        with self._lock:
            return dict(self._serve_stats)

    # ------------------------------------------------------------ bg threads
    #
    # Each loop is get -> process -> task_done; the processing bodies are
    # separate methods so a test (or a schedule audit)
    # can replay queued work inline at chosen yield points.  Worker
    # exceptions are published under the lock and re-raised on the main
    # thread by _check_bg at the next API call.
    def _process_write_item(self, item):
        key, entry = item
        try:
            vals, acc = entry
            t = self._table_of(key)
            _write_page_atomic(t.page_path(key[1]), vals, acc)
            with self._lock:
                self._stats["disk_bytes_written"] += vals.nbytes + acc.nbytes
                # only retire the lookaside if it still holds OUR entry (a
                # newer flush may have queued a fresher write); the bump
                # invalidates any page fault whose file read raced this
                # write (see _page_apply's generation guard)
                if self._in_flight.get(key) is entry:
                    del self._in_flight[key]
                    self._page_gen[key] = self._page_gen.get(key, 0) + 1
        except BaseException as e:  # surfaced via _check_bg
            with self._lock:
                self._bg_error = e

    def _process_read_item(self, item):
        name, p = item
        try:
            with self._lock:
                t = self._tables.get(name)
                stopping = self._stop.is_set()
            if t is not None and not stopping:
                self._page_apply(t, p)
        except BaseException as e:  # surfaced via _check_bg
            with self._lock:
                self._bg_error = e

    def _writer_loop(self):
        while True:
            item = self._write_q.get()
            try:
                if item is None:
                    return
                self._process_write_item(item)
            finally:
                self._write_q.task_done()

    def _reader_loop(self):
        while True:
            item = self._read_q.get()
            try:
                if item is None:
                    return
                self._process_read_item(item)
            finally:
                self._read_q.task_done()


# ------------------------------------------------------------------ helpers
def _page_groups(uids: np.ndarray, page_rows: int):
    """``(page, positions, rows in the page)`` for each page ``uids``
    touch, pages ascending, positions ascending within a page (the order
    the reference's per-page boolean masks give, so a repeated uid's last
    write still wins), in O(n log n) rather than a pass over ``uids`` per
    page."""
    pages = uids // page_rows
    order = np.argsort(pages, kind="stable")
    sorted_pages = pages[order]
    cuts = np.flatnonzero(np.diff(sorted_pages)) + 1
    for sel in np.split(order, cuts):
        if sel.size:
            p = int(pages[sel[0]])
            yield p, sel, uids[sel] - p * page_rows


def _write_page_atomic(path: str, rows: np.ndarray, accum: np.ndarray):
    """npz to ``.tmp`` + fsync + ``os.replace``: readers only ever see
    complete pages.

    Writes again if the ``.tmp`` vanishes between fsync and replace: a
    wreckage sweep (``sweep_stray_tmp``) may race a live write-behind, and
    from its view any ``.tmp`` is deletable; a rewrite is always safe.
    """
    tmp = path + ".tmp"
    for attempt in range(3):
        with open(tmp, "wb") as f:
            np.savez(f, rows=rows, accum=accum)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.replace(tmp, path)
            return
        except FileNotFoundError:
            if attempt == 2:
                raise


def _copy_file_atomic(src: str, dst: str):
    tmp = dst + ".tmp"
    with open(src, "rb") as fsrc, open(tmp, "wb") as fdst:
        while True:
            chunk = fsrc.read(1 << 22)
            if not chunk:
                break
            fdst.write(chunk)
        fdst.flush()
        os.fsync(fdst.fileno())
    os.replace(tmp, dst)


def sweep_stray_tmp(root: str) -> int:
    """Delete ``*.tmp`` page wreckage under ``root`` (kill mid write-behind
    or mid page-copy).  Safe by construction: a ``.tmp`` is only ever an
    incomplete write whose complete predecessor (if any) still holds the
    final name.  Returns the number of files removed."""
    removed = 0
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".tmp"):
                os.remove(os.path.join(dirpath, fn))
                removed += 1
    return removed


def make_store(store: str = "host", spill_dir: Optional[str] = None,
               page_rows: int = 1024,
               page_cache_pages: Optional[int] = None):
    """``store`` in {"host", "disk"} -> a RowStore instance."""
    if store == "host":
        if spill_dir is not None:
            raise ValueError("spill_dir is a disk-store option; "
                             "remove it or pass store='disk'")
        return HostStore()
    if store == "disk":
        if not spill_dir:
            raise ValueError("store='disk' requires spill_dir")
        return DiskStore(spill_dir, page_rows=page_rows,
                         page_cache_pages=page_cache_pages)
    raise ValueError(f"unknown store {store!r}; use 'host' or 'disk'")
