"""The port's double-buffered pull prefetch (the paper's Fig. 5 pipeline), on
the CPU: each test of ``tests/test_prefetch.py`` held by the port, plus the
online loop, the launcher's serving loop, the other recsys archs and the
reference's own prefetched ``fit``.

Tolerances, and why:
  - Within the port, prefetched against synchronous: EXACT.  Prefetch
    changes when a pull is issued, never what it computes: the same plan
    and table code run in the same order on the same tensors.  Dense tree,
    tables, accumulators, backend state, the DiskStore's rows and every
    history record except ``sec`` are bit-equal.  The DiskStore's page
    meters are not: when its reader thread lands a read-ahead page depends
    on the schedule, so they are held only to be finite and non-negative
    (ROADMAP.md §C), after ``_read_q.join()``.
  - The port's prefetched ``fit`` against the reference's, from one state:
    rtol = 1e-4, atol = 1e-6 (``SLICE`` of ``tests/test_torch_train.py``:
    the dense tower's sums run in other orders in the two frameworks).
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.core.kstep import KStepConfig as JKStepConfig
from repro.core.sparse_optim import SparseAdagradConfig as JSparseConfig
from repro.data import synthetic as JS
from repro.runtime.factory import build_trainer as jbuild_trainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.core.kstep import KStepConfig
from repro_torch.core.sparse_optim import SparseAdagradConfig
from repro_torch.data import synthetic as S
from repro_torch.interop import from_reference
from repro_torch.kernels import ops
from repro_torch.launch import train as launch
from repro_torch.models import recsys as R
from repro_torch.runtime.factory import build_ctr_engine, build_trainer
from repro_torch.runtime.online import fit_online
from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

torch.set_num_threads(1)

ROWS = 20_000
SLICE = dict(rtol=1e-4, atol=1e-6)
PAGE_METERS = ("page_hit_rate", "pages_evicted", "disk_bytes_read",
               "disk_bytes_written")


def _tcfg(placement, prefetch, store="host", spill=None, ckpt_dir=None,
          cls=TrainerConfig, kcls=KStepConfig, scls=SparseAdagradConfig,
          **kw):
    if store == "disk":
        # pages of 1024 rows (20 a table) behind a 4-page cache: pages evict
        kw.update(store="disk", spill_dir=spill, page_rows=1024,
                  page_cache_pages=4)
    return cls(
        n_pod=2, kstep=kcls(lr=1e-3, k=5, b1=0.0),
        sparse=scls(lr=0.5, initial_accumulator=0.01),
        placement=placement, capacity=4096,
        cache_rows=4096 if placement == "cached" else None,
        prefetch=prefetch, log_every=3, ckpt_dir=ckpt_dir, ckpt_every=6,
        **kw)


def _batches(n, seed=9):
    gen = S.ctr_batches(seed=seed, batch=256, rows=ROWS, n_fields=8, nnz=20,
                        zipf_a=1.05)
    return [next(gen) for _ in range(n)]


def _trainer(placement, prefetch, store="host", spill=None, **kw):
    return build_trainer("baidu-ctr", _tcfg(placement, prefetch, store,
                                            spill, **kw), device="cpu")


def _state(tr):
    """Everything the trainer trains, as numpy: the dense tree, the
    moments, the backend state and, from the authoritative tier, the rows
    and accumulators (the DiskStore synced and read back)."""
    out = {}

    def put(prefix, tree):
        if torch.is_tensor(tree):
            out[prefix] = tree.detach().numpy().copy()
        elif isinstance(tree, dict):
            for k, v in tree.items():
                put(f"{prefix}/{k}", v)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                put(f"{prefix}/{i}", v)

    put("dense", tr.dense)
    for f in ("m", "v_local", "v_hat"):
        put(f, getattr(tr.opt_state, f))
    put("bstate", tr.backend_state)
    eng = tr.engine
    if eng.store.kind == "disk":
        eng.sync_store(tr.tables, tr.sparse_state.accum, tr.backend_state)
        for n, s in eng.specs.items():
            rows, acc = eng.store.gather(n, np.arange(s.rows, dtype=np.int64))
            out[f"rows/{n}"], out[f"accum/{n}"] = rows, acc
    else:
        put("tables", tr.tables)
        put("accum", tr.sparse_state.accum)
    return out


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_history_equal(ha, hb, disk=False):
    """Every record equal but ``sec``; on disk the page meters only finite
    and non-negative (the reader thread's schedule moves them)."""
    assert len(ha) == len(hb) > 0
    for ra, rb in zip(ha, hb):
        skip = {"sec"}
        if disk:
            skip |= {k for k in ra if k.removesuffix("_total") in PAGE_METERS}
            for k in skip - {"sec"}:
                assert np.isfinite(ra[k]) and ra[k] >= 0, k
                assert np.isfinite(rb[k]) and rb[k] >= 0, k
        assert ({k: v for k, v in ra.items() if k not in skip}
                == {k: v for k, v in rb.items() if k not in skip})


# ------------------------------------------------- prefetched = synchronous
@pytest.mark.parametrize("placement,store", [
    ("gather", "host"), ("cached", "host"), ("gather", "disk"),
    ("cached", "disk"), ("routed", "host")])
def test_prefetched_fit_bit_identical(placement, store, tmp_path):
    """Prefetch changes WHEN the pull is issued, never WHAT it computes: the
    pull of batch t+1 commutes with the push of batch t except through the
    table/accum/state hand-off, which the commit serializes.  The routed
    placement is not ported (queue A8) and raises with or without it."""
    if placement == "routed":
        with pytest.raises(NotImplementedError, match="A8"):
            _trainer(placement, prefetch=True)
        return
    batches = _batches(12)
    t_sync = _trainer(placement, False, store, str(tmp_path / "sync"))
    h_sync = t_sync.fit(iter(batches), 12)
    t_pre = _trainer(placement, True, store, str(tmp_path / "pre"))
    h_pre = t_pre.fit(iter(batches), 12)
    assert t_pre._prefetcher.pending is None
    _assert_history_equal(h_sync, h_pre, disk=store == "disk")
    _assert_state_equal(_state(t_sync), _state(t_pre))
    if placement == "cached":
        assert h_pre[-1]["evictions_total"] > 0
    if store == "disk":
        for t in (t_sync, t_pre):
            t.engine.store._read_q.join()
            st = t.engine.store.stats()
            assert all(np.isfinite(v) and v >= 0 for v in st.values())
            assert st["pages_evicted"] > 0
            t.close()


@pytest.mark.parametrize("store", ["host", "disk"])
def test_prefetch_checkpoint_resume_bitexact(store, tmp_path):
    """Crash and resume mid-way through a prefetched cached run:
    checkpoints land at commit boundaries (never capturing the speculative
    pull), so the resumed prefetched run matches an uninterrupted
    SYNCHRONOUS run bit for bit, on the host store and on the DiskStore
    (its pages in the checkpoint)."""
    batches = _batches(18)
    ref = _trainer("cached", False, store, str(tmp_path / "ref"))
    for b in batches:
        ref.train_step(b)

    d = str(tmp_path / "ckpt")
    spill = str(tmp_path / "run")
    t_a = _trainer("cached", True, store, spill, ckpt_dir=d)
    t_a.fit(iter(batches[:12]), 12)    # ckpt_every=6 -> ckpts at 6 and 12
    if store == "disk":
        t_a.engine.store.close()
    del t_a  # crash after step 12

    t_b = _trainer("cached", True, store, spill, ckpt_dir=d)
    assert t_b.resume() and t_b.step_num == 12
    t_b.fit(iter(batches[12:]), 6)
    _assert_state_equal(_state(ref), _state(t_b))
    for t in (ref, t_b):
        t.close()


def test_prefetch_pipeline_misuse_is_loud():
    """The one-deep pipeline never silently trains on the wrong batch, and
    never checkpoints a speculative pull."""
    tr = _trainer("gather", prefetch=True)
    b1, b2 = _batches(2)
    assert tr.prefetch(b1) is True
    assert tr.prefetch(b1) is True          # idempotent for the same batch
    with pytest.raises(RuntimeError, match="different batch"):
        tr.prefetch(b2)
    with pytest.raises(RuntimeError, match="in flight"):
        tr.save()
    with pytest.raises(RuntimeError, match="different batch"):
        tr.train_step(b2)
    # a caught misuse error must not shift the step/merge/ckpt cadence
    assert tr.step_num == 0
    tr.train_step(b1)                       # the right batch commits the pull
    assert tr._prefetcher.pending is None
    tr.train_step(b2)                       # cold start: pulls synchronously
    assert tr.step_num == 2
    with pytest.raises(RuntimeError, match="no pull in flight"):
        tr._prefetcher.commit()
    assert _trainer("gather", prefetch=False).prefetch(b1) is False


@pytest.mark.parametrize("placement,store", [
    ("cached", "host"), ("gather", "disk"), ("cached", "disk")])
def test_predict_mid_flight_matches_sync(placement, store, tmp_path):
    """The online predict-then-train protocol: predictions read the
    in-flight pull's state and equal the synchronous run's exactly (a pull
    moves rows coherently; only a push changes values).  On the DiskStore
    the lookup lays the pending staged rows (the previous step's pushed
    rows, or the pending pull's spills and pass-through rows) over its
    page reads."""
    batches = _batches(6)
    t_sync = _trainer(placement, False, store, str(tmp_path / "sync"))
    t_pre = _trainer(placement, True, store, str(tmp_path / "pre"))
    for b in batches:
        p_sync = t_sync.predict(b)
        t_sync.train_step(b)
        t_pre.prefetch(b)
        assert t_pre._prefetcher.pending is not None
        p_pre = t_pre.predict(b)            # the pull for b is in flight
        t_pre.train_step(b)
        np.testing.assert_array_equal(p_sync, p_pre)
    _assert_state_equal(_state(t_sync), _state(t_pre))
    for t in (t_sync, t_pre):
        t.close()


def test_train_step_prefetched_manual_loop():
    """The manual-loop convenience wrapper pipelines as fit does."""
    batches = _batches(6)
    t_sync = _trainer("gather", prefetch=False)
    for b in batches:
        t_sync.train_step(b)
    t_pre = _trainer("gather", prefetch=True)
    for i, b in enumerate(batches):
        nxt = batches[i + 1] if i + 1 < len(batches) else None
        t_pre.train_step_prefetched(b, nxt)
        assert (t_pre._prefetcher.pending is None) == (nxt is None)
    _assert_state_equal(_state(t_sync), _state(t_pre))


def test_hot_path_returns_device_values():
    """train_step does not read the loss on the host: it comes back as a
    tensor on the trainer's device, the overflow counter stays there, and
    only the property and the metrics read it."""
    tr = _trainer("gather", prefetch=True)
    b1, b2 = _batches(2)
    tr.prefetch(b1)
    loss = tr.train_step_prefetched(b1, b2)
    assert torch.is_tensor(loss) and loss.device == tr.device
    assert torch.is_tensor(tr._overflow) and tr._overflow.device == tr.device
    assert isinstance(tr.overflow_dropped, int) and tr.overflow_dropped == 0
    p = tr._prefetcher.pending
    assert p.event is None              # the CPU runs the plan in order
    assert all(ws.rows.device == tr.device for ws in p.wss.values())


def test_dense_trainer_rejects_prefetch():
    with pytest.raises(ValueError, match="prefetch"):
        build_trainer("qwen3-14b", TrainerConfig(
            n_pod=2, kstep=KStepConfig(lr=1e-3, k=2, b1=0.9), prefetch=True,
        ), device="cpu")


# ------------------------------------------------ the loops and other archs
@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_fit_online_prefetched_matches_sync(placement):
    """fit_online issues each batch's pull before its predict/train pair:
    scores (the streaming AUC), history and state as without prefetch."""
    runs = []
    for prefetch in (False, True):
        tr = _trainer(placement, prefetch)
        hist, auc = fit_online(tr, iter(_batches(9, seed=4)), 9, window=5)
        runs.append((tr, hist, auc))
    (ta, ha, auca), (tb, hb, aucb) = runs
    assert auca == aucb and 0.0 < auca < 1.0
    _assert_history_equal(ha, hb)
    assert "auc" in hb[-1]
    _assert_state_equal(_state(ta), _state(tb))


def _launch(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(list(argv))
    return out.getvalue().strip().splitlines()


def _fields(line):
    """The final line's words without its timing fields (qps, p50, p99,
    steps/s) and the prefetch flag."""
    words = line.split()
    drop = set()
    for i, w in enumerate(words):
        if w in ("qps", "p50", "p99", "prefetch"):
            drop |= {i, i + 1}
    return [w for i, w in enumerate(words)
            if i not in drop and not w.startswith("(")]


@pytest.mark.parametrize("placement,serve", [
    ("gather", True), ("cached", True), ("cached", False)])
def test_launcher_prefetch_matches_sync(placement, serve, tmp_path):
    """``--prefetch`` in the launcher's serving loop (a pull in flight
    while the co-located server drains) and its online loop: the same
    final loss, served count, hit rates and AUC as without it."""
    args = ["--arch", "baidu-ctr", "--steps", "4", "--device", "cpu",
            "--batch", "32", "--k", "2", "--placement", placement,
            "--rows", "2000"]
    if placement == "cached":
        args += ["--capacity", "512", "--cache-rows", "512"]
    if serve:
        args += ["--serve", "--serve-batch", "8"]
    sync = _launch(*args)[-1]
    pre = _launch(*args, "--prefetch")[-1]
    assert "prefetch False" in sync and "prefetch True" in pre
    assert _fields(sync) == _fields(pre)
    if serve:
        assert "served 32" in pre


@pytest.mark.parametrize("placement", ["gather", "cached"])
@pytest.mark.parametrize("arch", ["dlrm-mlperf", "din"])
def test_other_archs_prefetched_match_sync(arch, placement):
    """DLRM (26 tables: 26 plans a pull) and DIN (one item table fed by the
    history and the target) at smoke size."""
    mcfg = configs.get(arch).smoke_cfg
    gen = S.recsys_batches(mcfg, batch=32, seed=3)
    batches = [next(gen) for _ in range(6)]
    runs = []
    for prefetch in (False, True):
        tcfg = TrainerConfig(
            n_pod=2, kstep=KStepConfig(lr=1e-3, k=2),
            sparse=SparseAdagradConfig(lr=0.1, initial_accumulator=0.01),
            placement=placement, capacity=512,
            cache_rows=512 if placement == "cached" else None,
            prefetch=prefetch, log_every=2)
        tr = build_trainer(arch, tcfg, seed=2, device="cpu")
        ops.reset_launches()
        hist = tr.fit(iter(batches), 6)
        runs.append((tr, hist, dict(ops.launches)))
    (ta, ha, la), (tb, hb, lb) = runs
    _assert_history_equal(ha, hb)
    assert la == lb                      # prefetch adds no work, drops none
    _assert_state_equal(_state(ta), _state(tb))


# ------------------------------------------------------- against the reference
@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_prefetched_fit_matches_reference_prefetched_fit(placement):
    """The reference's prefetched ``fit`` and the port's from one state
    (``interop.from_reference``), 6 steps (a merge at step 5): losses,
    dense tree, moments, tables and accumulators within SLICE; overflow and
    cache counters equal.  The reference runs its fused kernels (interpret
    mode), whose push rounds ``a + g*g`` once, as the port does
    (``tests/test_torch_train.py``)."""
    jtr = jbuild_trainer("baidu-ctr", _tcfg(
        placement, True, cls=JTrainerConfig, kcls=JKStepConfig,
        scls=JSparseConfig, fused_kernels=True), seed=3)
    state = from_reference(
        jax.device_get(jtr.dense), jax.device_get(jtr.tables),
        jax.device_get(jtr.sparse_state.accum),
        jax.device_get(jtr.opt_state), device="cpu")
    tcfg = _tcfg(placement, True)
    mcfg = configs.get("baidu-ctr").smoke_cfg
    tr = HybridTrainer(None, build_ctr_engine(mcfg, tcfg, device="cpu"),
                       R.ctr_embed_from_workings(mcfg),
                       R.ctr_hybrid_loss(mcfg), tcfg, state=state,
                       device="cpu")
    jgen = JS.ctr_batches(seed=9, batch=256, rows=ROWS, n_fields=8, nnz=20,
                          zipf_a=1.05)
    batches = [next(jgen) for _ in range(6)]
    jh = jtr.fit(iter(batches), 6)
    h = tr.fit(iter([{k: np.asarray(v) for k, v in b.items()}
                      for b in batches]), 6)
    assert [r["step"] for r in h] == [r["step"] for r in jh] == [3, 6]
    np.testing.assert_allclose([r["loss"] for r in h],
                               [r["loss"] for r in jh], **SLICE)
    for key in ("overflow_dropped", "evictions", "evictions_total",
                "cache_hit_rate"):
        if key in jh[-1]:
            assert [r[key] for r in h] == [r[key] for r in jh], key
    jdense = jax.device_get(jtr.dense)
    got, want = {}, {}

    def flat(prefix, tree, out):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(f"{prefix}/{k}", v, out)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                flat(f"{prefix}/{i}", v, out)
        else:
            out[prefix] = np.asarray(
                tree.detach().numpy() if torch.is_tensor(tree) else tree)

    flat("dense", tr.dense, got)
    flat("dense", jdense, want)
    for f in ("m", "v_hat"):
        flat(f, getattr(tr.opt_state, f), got)
        flat(f, jax.device_get(getattr(jtr.opt_state, f)), want)
    t, a, _ = tr.engine.flush(tr.tables, tr.sparse_state.accum,
                              tr.backend_state)
    jt, ja, _ = jtr.engine.flush(jtr.tables, jtr.sparse_state.accum,
                                 jtr.backend_state)
    flat("tables", t, got)
    flat("accum", a, got)
    flat("tables", jax.device_get(jt), want)
    flat("accum", jax.device_get(ja), want)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **SLICE)


@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_backend_pull_and_lookup_take_the_plan(placement):
    """A backend's ``plan`` (the ids-only part) handed to ``pull`` or
    ``lookup`` gives what they compute without it, bit for bit."""
    runs = []
    for planned in (False, True):
        tr = _trainer(placement, prefetch=False)
        eng, be = tr.engine, tr.engine.backend
        out = []
        for b in _batches(3, seed=2):
            ids = eng.ids_from_batch(tr._stage(b))["sparse"]
            kw = {"plan": be.plan(ids, eng.capacity)} if planned else {}
            ws, aux = be.lookup(tr.tables["sparse"],
                                tr.sparse_state.accum["sparse"],
                                tr.backend_state["sparse"], ids,
                                eng.capacity, **kw)
            out += [*ws, *aux.values()]
            ws, *_ = be.pull(tr.tables["sparse"],
                             tr.sparse_state.accum["sparse"],
                             tr.backend_state["sparse"], ids, eng.capacity,
                             **kw)
            out += list(ws)
        runs.append(out + list(_state(tr).values()))
    assert len(runs[0]) == len(runs[1])
    for x, y in zip(*runs):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_close_with_a_pull_pending_leaves_the_synchronous_store(
        placement, tmp_path):
    """``close()`` while a prefetched pull is pending on the DiskStore: its
    ``sync_store`` absorbs the pending pull's staged rows, which are the
    store's own values (absorbing unchanged rows again is idempotent), so
    the reopened pages equal the synchronous run's after the same steps."""
    from repro_torch.core.row_store import DiskStore

    batches = _batches(7)
    t_sync = _trainer(placement, False, "disk", str(tmp_path / "sync"))
    for b in batches[:6]:
        t_sync.train_step(b)
    t_sync.close()
    t_pre = _trainer(placement, True, "disk", str(tmp_path / "pre"))
    for i in range(6):
        t_pre.train_step_prefetched(batches[i], batches[i + 1])
    assert t_pre._prefetcher.pending is not None   # batch 7's pull
    t_pre.close()
    got = []
    for d in ("sync", "pre"):
        st = DiskStore(str(tmp_path / d), page_rows=1024)
        st.create_table("sparse", ROWS, 16, np.float32)
        got.append(st.gather("sparse", np.arange(ROWS)))
        st.close()
    for x, y in zip(*got):
        np.testing.assert_array_equal(x, y)
