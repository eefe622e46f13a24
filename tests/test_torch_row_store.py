"""The port's DiskStore (the SSD tier's page store), store-level.

The cases of the reference's ``tests/test_row_store.py`` that test the
store itself, run against ``repro_torch.core.row_store`` (no JAX here):
pages round-trip, write-behind and flush, a bounded page cache that evicts
and stays correct, read-ahead, snapshot and restore, a missing page, the
factory's rules, the stray ``.tmp`` sweep, the fault-window race, a wedged
worker at close, and a ``.tmp`` swept mid-write.  Plus what the port adds:
``gather(out=...)``, accumulator rows given at creation, and the page
grouping.  Every value is compared exactly (the store copies bytes).

No test waits on a thread without a time limit of its own: the waits are
polls with a deadline (``_wait_idle``), joins take a timeout.
"""

import os
import threading
import time
import unittest.mock as mock

import numpy as np
import pytest

from repro_torch.core import row_store as RS
from repro_torch.core.row_store import (
    DiskStore,
    HostStore,
    make_store,
    sweep_stray_tmp,
)


def _mk_store(tmp_path, **kw):
    return DiskStore(str(tmp_path / "spill"), **kw)


def _init_fn(start, stop):
    # row r filled with r: page-local slicing errors show up as value errors
    return np.arange(start, stop, dtype=np.float32)[:, None] * np.ones(
        (1, 4), np.float32)


def _wait_idle(q, timeout=10.0):
    """Wait until ``q`` has no unfinished task, at most ``timeout`` s."""
    deadline = time.monotonic() + timeout
    while q.unfinished_tasks:
        assert time.monotonic() < deadline, "a store worker did not drain"
        time.sleep(0.005)


def test_create_gather_roundtrip(tmp_path):
    st = _mk_store(tmp_path, page_rows=8)
    st.create_table("t", rows=50, dim=4, dtype=np.float32,
                    init_rows_fn=_init_fn, accum_init=0.25)
    uids = np.array([0, 7, 8, 49, 13], np.int64)   # page edges, short page
    vals, acc = st.gather("t", uids)
    np.testing.assert_array_equal(vals, _init_fn(0, 50)[uids])
    np.testing.assert_array_equal(acc, np.full((5, 4), 0.25, np.float32))
    assert st.table_meta("t") == {"rows": 50, "dim": 4, "dtype": "float32",
                                  "page_rows": 8}
    assert st.has_table("t") and not st.has_table("u")
    st.close()


def test_gather_into_given_arrays_and_accum_rows_at_creation(tmp_path):
    """``gather(out=...)`` fills the caller's arrays (the engine's pinned
    staging buffers) and ``init_accum_fn`` gives the accumulator rows (a
    state loaded from elsewhere)."""
    st = _mk_store(tmp_path, page_rows=8)
    acc_all = np.random.default_rng(0).random((30, 4)).astype(np.float32)
    st.create_table("t", rows=30, dim=4, dtype=np.float32,
                    init_rows_fn=_init_fn,
                    init_accum_fn=lambda a, b: acc_all[a:b])
    uids = np.array([29, 3, 3, 17, 8], np.int64)
    out = (np.full((5, 4), -1, np.float32), np.full((5, 4), -1, np.float32))
    got = st.gather("t", uids, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    np.testing.assert_array_equal(out[0], _init_fn(0, 30)[uids])
    np.testing.assert_array_equal(out[1], acc_all[uids])
    with pytest.raises(ValueError, match="out must be"):
        st.gather("t", uids, out=(np.empty((4, 4), np.float32),
                                  np.empty((4, 4), np.float32)))
    st.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_groups_match_per_page_masks(seed):
    """The O(n log n) grouping gives the reference's per-page boolean-mask
    selections, in the same order (so a repeated uid's last write wins in
    both)."""
    rng = np.random.default_rng(seed)
    uids = rng.integers(0, 500, 300).astype(np.int64)
    uids[-20:] = uids[0]                              # pads, repeated ids
    got = list(RS._page_groups(uids, 16))
    want = []
    for p in np.unique(uids // 16):
        sel = uids // 16 == p
        want.append((int(p), np.flatnonzero(sel), uids[sel] - int(p) * 16))
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, gs, gr), (_, ws, wr) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gr, wr)


def test_scatter_write_behind_and_flush(tmp_path):
    st = _mk_store(tmp_path, page_rows=8)
    st.create_table("t", rows=32, dim=4, dtype=np.float32)
    uids = np.array([3, 9, 31], np.int64)
    rows = np.full((3, 4), 7.0, np.float32)
    accum = np.full((3, 4), 2.0, np.float32)
    st.scatter("t", uids, rows, accum)
    # visible through the cache immediately...
    v, a = st.gather("t", uids)
    np.testing.assert_array_equal(v, rows)
    np.testing.assert_array_equal(a, accum)
    # ...and durable on disk after flush: a FRESH store sees the values
    st.flush()
    st.close()
    st2 = _mk_store(tmp_path, page_rows=8)
    st2.create_table("t", rows=32, dim=4, dtype=np.float32)  # adopts pages
    v, a = st2.gather("t", uids)
    np.testing.assert_array_equal(v, rows)
    np.testing.assert_array_equal(a, accum)
    st2.close()


def test_bounded_cache_evicts_and_stays_correct(tmp_path):
    st = _mk_store(tmp_path, page_rows=4, page_cache_pages=2)
    st.create_table("t", rows=64, dim=4, dtype=np.float32,
                    init_rows_fn=_init_fn)
    # touch every page, writing as we go: evictions must persist dirty pages
    for lo in range(0, 64, 4):
        uids = np.arange(lo, lo + 4, dtype=np.int64)
        v, a = st.gather("t", uids)
        st.scatter("t", uids, v + 1.0, a + 1.0)
    v, _ = st.gather("t", np.arange(64, dtype=np.int64))
    np.testing.assert_array_equal(v, _init_fn(0, 64) + 1.0)
    stats = st.stats()
    assert stats["pages_evicted"] > 0
    assert stats["disk_bytes_written"] > 0
    st.close()


def test_readahead_warms_pages(tmp_path):
    st = _mk_store(tmp_path, page_rows=8)
    st.create_table("t", rows=64, dim=4, dtype=np.float32)
    uids = np.array([1, 17, 42], np.int64)
    st.readahead("t", uids)
    _wait_idle(st._read_q)          # the reader thread is asynchronous
    before = st.stats()
    st.gather("t", uids)
    after = st.stats()
    # all three pages were faulted in by the reader: gather only hits
    assert after["page_hits"] - before["page_hits"] == 3
    assert after["page_misses"] == before["page_misses"]
    st.close()


def test_serve_reads_meter_apart(tmp_path):
    """``gather(serve=True)`` meters into ``serve_stats`` only."""
    st = _mk_store(tmp_path, page_rows=8)
    st.create_table("t", rows=64, dim=4, dtype=np.float32)
    st.gather("t", np.array([1, 9], np.int64), serve=True)
    assert st.stats()["page_misses"] == 0
    assert st.serve_stats()["page_misses"] == 2
    st.close()


def test_snapshot_restore_roundtrip(tmp_path):
    st = _mk_store(tmp_path, page_rows=8)
    st.create_table("t", rows=20, dim=4, dtype=np.float32,
                    init_rows_fn=_init_fn, accum_init=0.5)
    snap = str(tmp_path / "snap")
    st.snapshot_to(snap)
    # mutate after the snapshot, then restore: the mutation must vanish
    st.scatter("t", np.arange(20, dtype=np.int64),
               np.zeros((20, 4), np.float32), np.zeros((20, 4), np.float32))
    st.restore_from(snap)
    v, a = st.gather("t", np.arange(20, dtype=np.int64))
    np.testing.assert_array_equal(v, _init_fn(0, 20))
    np.testing.assert_array_equal(a, np.full((20, 4), 0.5, np.float32))
    st.close()


def test_restore_missing_page_raises(tmp_path):
    st = _mk_store(tmp_path, page_rows=8)
    st.create_table("t", rows=20, dim=4, dtype=np.float32)
    snap = str(tmp_path / "snap")
    st.snapshot_to(snap)
    os.remove(os.path.join(snap, "t", "page_000001.npz"))
    with pytest.raises(FileNotFoundError):
        st.restore_from(snap)
    st.close()


def test_make_store_validation(tmp_path):
    assert isinstance(make_store("host"), HostStore)
    with pytest.raises(ValueError, match="spill_dir is a disk-store option"):
        make_store("host", spill_dir=str(tmp_path))
    with pytest.raises(ValueError, match="requires spill_dir"):
        make_store("disk")
    with pytest.raises(ValueError, match="unknown store"):
        make_store("tape")
    with pytest.raises(ValueError, match="page_rows must be positive"):
        DiskStore(str(tmp_path / "s"), page_rows=0)
    with pytest.raises(ValueError, match="page_cache_pages must be positive"):
        DiskStore(str(tmp_path / "s"), page_cache_pages=0)
    st = make_store("disk", spill_dir=str(tmp_path / "d"), page_rows=16,
                    page_cache_pages=3)
    assert (st.kind, st.page_rows, st.page_cache_pages) == ("disk", 16, 3)
    st.close()


def test_stray_tmp_swept_on_init(tmp_path):
    """A kill mid write-behind leaves ``<page>.npz.tmp`` wreckage: the next
    DiskStore boot sweeps it, and the complete predecessor page survives."""
    spill = tmp_path / "spill"
    st = DiskStore(str(spill), page_rows=8)
    st.create_table("t", rows=16, dim=4, dtype=np.float32,
                    init_rows_fn=_init_fn)
    st.close()
    wreck = spill / "t" / "page_000000.npz.tmp"
    wreck.write_bytes(b"torn half-written page")
    st2 = DiskStore(str(spill), page_rows=8)
    assert not wreck.exists()
    st2.create_table("t", rows=16, dim=4, dtype=np.float32)
    v, _ = st2.gather("t", np.arange(8, dtype=np.int64))
    np.testing.assert_array_equal(v, _init_fn(0, 8))  # old page intact
    st2.close()


def test_fault_window_race_with_writeback_retirement(tmp_path):
    """Lost-update regression: while a page fault reads its file with the
    lock released, a racing thread faults + scatters the same page, the
    dirty page is evicted into the write-behind queue, the write lands,
    AND the lookaside retires, all inside the fault window.  On reacquire
    both the cache and the lookaside are empty, so without the generation
    guard the fault would install its pre-scatter file bytes as a clean
    page, shadowing the scatter."""
    st = _mk_store(tmp_path, page_rows=4, page_cache_pages=1)
    st.create_table("t", rows=8, dim=2, dtype=np.float32)
    new_rows = np.full((2, 2), 5.0, np.float32)
    new_acc = np.full((2, 2), 1.0, np.float32)
    fired = []

    def interfere(key):
        # one-shot, page 0 only: the inner scatters re-enter the fault
        # path (for page 0 and page 1) and must not recurse
        if fired or key[1] != 0:
            return
        fired.append(key)
        # the racing thread, run inline in the fault window:
        st.scatter("t", np.array([0, 1], np.int64), new_rows, new_acc)
        # faulting page 1 into the 1-page cache evicts dirty page 0 into
        # the write-behind queue...
        st.scatter("t", np.array([4], np.int64),
                   np.full((1, 2), 9.0, np.float32),
                   np.full((1, 2), 2.0, np.float32))
        # ...and the real writer thread lands it and retires the lookaside
        _wait_idle(st._write_q)

    st._fault_hook = interfere
    v, a = st.gather("t", np.arange(4, dtype=np.int64))
    assert fired, "fault hook never fired: page 0 was not faulted"
    np.testing.assert_array_equal(v[:2], new_rows)
    np.testing.assert_array_equal(a[:2], new_acc)
    np.testing.assert_array_equal(v[2:], np.zeros((2, 2), np.float32))
    st._fault_hook = None
    st.close()


def test_background_error_reraises_on_next_call(tmp_path):
    """A failed write-behind surfaces at the next store call."""
    st = _mk_store(tmp_path, page_rows=4, page_cache_pages=1)
    st.create_table("t", rows=8, dim=2, dtype=np.float32)
    with mock.patch.object(RS, "_write_page_atomic",
                           side_effect=OSError("disk full")):
        st.scatter("t", np.array([0], np.int64),
                   np.ones((1, 2), np.float32), np.ones((1, 2), np.float32))
        st.gather("t", np.array([4], np.int64))      # evicts the dirty page
        _wait_idle(st._write_q)
    with pytest.raises(RuntimeError, match="background IO failed"):
        st.gather("t", np.array([4], np.int64))
    st.close()


def test_close_raises_on_wedged_worker(tmp_path, monkeypatch):
    """A worker still alive after the join timeout must fail close()
    loudly: a wedged IO thread may be mid page write."""
    st = _mk_store(tmp_path, page_rows=8)
    st.create_table("t", rows=8, dim=2, dtype=np.float32)
    gate = threading.Event()

    def stuck(item):
        gate.wait(timeout=30)   # simulate a writer wedged in IO

    monkeypatch.setattr(st, "_process_write_item", stuck)
    st._write_q.put(("wedge", None))
    # flush would block behind the wedged write; close()'s join-timeout
    # path is what is tested, so skip it, and make the 30 s join a no-op
    monkeypatch.setattr(st, "flush", lambda: None)
    monkeypatch.setattr(st._writer, "join", lambda timeout=None: None)
    try:
        with pytest.raises(RuntimeError, match="still alive"):
            st.close()
    finally:
        gate.set()   # release the worker so the daemon thread can exit
        threading.Thread.join(st._writer, timeout=5)
    assert not st._writer.is_alive()


def test_write_page_survives_concurrent_tmp_sweep(tmp_path):
    """A sweep may delete a live write's .tmp between fsync and replace:
    the writer writes again instead of dying."""
    calls = {"n": 0}
    orig_replace = os.replace

    def flaky_replace(src, dst):
        if calls["n"] == 0 and src.endswith(".tmp"):
            calls["n"] += 1
            os.remove(src)              # the sweep got there first
            raise FileNotFoundError(src)
        return orig_replace(src, dst)

    path = str(tmp_path / "page_000000.npz")
    rows = np.ones((4, 2), np.float32)
    acc = np.zeros((4, 2), np.float32)
    with mock.patch.object(RS.os, "replace", side_effect=flaky_replace):
        RS._write_page_atomic(path, rows, acc)
    with np.load(path) as z:
        np.testing.assert_array_equal(z["rows"], rows)


def test_sweep_counts(tmp_path):
    (tmp_path / "a.npz.tmp").write_bytes(b"x")
    sub = tmp_path / "t"
    sub.mkdir()
    (sub / "b.npz.tmp").write_bytes(b"x")
    (sub / "keep.npz").write_bytes(b"x")
    assert sweep_stray_tmp(str(tmp_path)) == 2
    assert (sub / "keep.npz").exists()
