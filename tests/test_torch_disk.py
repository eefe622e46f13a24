"""The port's SSD tier (``--store disk``): the DiskStore under the staged
gather and cached placements, training and serving, on the CPU.

Tolerances, and why:
  - Within the port, the disk store against the host store: EXACT.  The
    staged rows are the table's rows (the host dedup mirrors the device
    dedup's layout), the staged push's row math is the host push's
    (``adagrad_row_updates``, then one add), the cached placement only
    moves rows between the tiers, and the page cache is a cache: losses,
    predictions, rows and accumulators bit-equal, with an unbounded and a
    bounded page cache.
  - The port against the reference on disk, 6 steps from one state:
    losses and final rows within rtol = 1e-4, atol = 1e-6 (the tolerance
    of ``tests/test_torch_train.py``: the dense tower's sums run in other
    orders, and the reference's ``apply_staged`` rounds ``a + g*g`` its own
    way).
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
from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.core.embedding_backend import (
    GatherBackend,
    make_backend,
    pull_working_set,
)
from repro_torch.core.embedding_engine import EmbeddingEngine
from repro_torch.core.kstep import KStepConfig
from repro_torch.core.row_store import DiskStore
from repro_torch.core.sparse_optim import SparseAdagradConfig
from repro_torch.data import synthetic as S
from repro_torch.interop import from_reference
from repro_torch.kernels import ops
from repro_torch.launch import train as launch
from repro_torch.models import recsys as R
from repro_torch.runtime.factory import build_ctr_engine, build_trainer
from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

torch.set_num_threads(1)

SMOKE = configs.get("baidu-ctr").smoke_cfg
CROSS = dict(rtol=1e-4, atol=1e-6)


def _tcfg(placement, store="host", spill=None, page_cache_pages=None, k=3):
    return TrainerConfig(
        n_pod=2, kstep=KStepConfig(lr=1e-3, k=k, merge="two_phase"),
        sparse=SparseAdagradConfig(lr=0.5, initial_accumulator=0.01),
        placement=placement, capacity=1024,
        cache_rows=1024 if placement == "cached" else None, store=store,
        spill_dir=spill, page_rows=256 if store == "disk" else None,
        page_cache_pages=page_cache_pages)


def _batches(n, batch=48, seed=1):
    gen = S.recsys_batches(SMOKE, batch=batch, seed=seed)
    return [next(gen) for _ in range(n)]


def _final_rows(tr):
    """(rows, accum) of every table from the authoritative store or
    placement, as numpy."""
    eng = tr.engine
    if eng.store.kind == "disk":
        eng.sync_store(tr.tables, tr.sparse_state.accum, tr.backend_state)
        return {n: eng.store.gather(n, np.arange(s.rows, dtype=np.int64))
                for n, s in eng.specs.items()}
    t, a, _ = eng.flush(tr.tables, tr.sparse_state.accum, tr.backend_state)
    return {n: (t[n].cpu().numpy().copy(), a[n].cpu().numpy().copy())
            for n in t}


def _run(tr, batches, requests):
    """Per step: train, then score a request batch (a co-located drain)."""
    losses, scores = [], []
    for b, r in zip(batches, requests):
        losses.append(float(tr.train_step(b)))
        scores.append(tr.predict(r))
    return losses, scores


@pytest.mark.parametrize("page_cache_pages", [None, 4])
@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_disk_bit_identical_to_host(placement, page_cache_pages, tmp_path):
    """Losses, every drain's scores, final rows and accumulators: the disk
    store gives the host store's bits, with an unbounded and a bounded
    page cache (79 pages of 256 rows through 4)."""
    batches, requests = _batches(5), _batches(5, batch=16, seed=2)
    host = build_trainer("baidu-ctr", _tcfg(placement), seed=4,
                         device="cpu")
    want = _run(host, batches, requests)
    want_rows = _final_rows(host)
    disk = build_trainer(
        "baidu-ctr", _tcfg(placement, "disk", str(tmp_path / "spill"),
                           page_cache_pages), seed=4, device="cpu")
    ops.reset_launches()
    got = _run(disk, batches, requests)
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    rows = _final_rows(disk)
    for n in want_rows:
        np.testing.assert_array_equal(rows[n][0], want_rows[n][0])
        np.testing.assert_array_equal(rows[n][1], want_rows[n][1])
    # the staged push ran (gather) as the counted plain version on the CPU
    assert ops.launches["sparse_adagrad_ref"] == (
        5 if placement == "gather" else 0)
    assert ops.launches["fused_adam_ref"] == 4         # steps 1, 2, 4, 5
    stats = disk.engine.store.stats()
    if page_cache_pages is not None:
        assert stats["pages_evicted"] > 0 and stats["disk_bytes_written"] > 0
    disk.close()


@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_lookup_stage_on_disk_serves_the_host_rows(placement, tmp_path):
    """The engine's LOOKUP stage under the DiskStore (``stage_lookup``,
    then the staged lookup) serves the rows the host store's lookup
    serves, with a push still un-absorbed."""
    batches, req = _batches(3), _batches(1, batch=16, seed=2)[0]
    out = []
    for store in ("host", "disk"):
        tr = build_trainer("baidu-ctr", _tcfg(
            placement, store, str(tmp_path / "s") if store == "disk"
            else None, 4 if store == "disk" else None), seed=7,
            device="cpu")
        for b in batches:
            tr.train_step(b)
        eng = tr.engine
        staged = tr._stage(req)
        wss, aux = eng.lookup_stage()(tr.tables, tr.sparse_state.accum,
                                      tr.backend_state,
                                      eng.ids_from_batch(staged))
        out.append((wss["sparse"], aux))
        tr.close()
    (h, h_aux), (d, d_aux) = out
    valid = torch.cat([torch.ones(1, dtype=torch.bool),
                       h.uids[1:] > h.uids[:-1]])
    assert torch.equal(h.uids, d.uids) and torch.equal(h.inverse, d.inverse)
    assert torch.equal(h.rows[:-1][valid], d.rows[:-1][valid])
    assert {k: float(v) for k, v in h_aux.items()} == {
        k: float(v) for k, v in d_aux.items()}


def test_host_dedup_mirrors_the_device_dedup():
    """``host_dedup`` gives ``pull_working_set``'s uid layout bit for bit
    (ascending, truncated keeping the smallest, padded by the minimum), and
    ``valid`` marks the first occurrences, with and without overflow."""
    eng = EmbeddingEngine(R.ctr_table_specs(SMOKE), capacity=64,
                          device="cpu")
    rng = np.random.default_rng(3)
    for n_ids, hi in ((40, 1000), (500, 1000), (64, 64), (1, 10)):
        ids = rng.integers(0, hi, n_ids).astype(np.int32)
        uids, valid = eng.host_dedup(ids)
        want, _ = pull_working_set(torch.from_numpy(ids), 64)
        np.testing.assert_array_equal(uids, want.numpy())
        first = np.r_[True, want.numpy()[1:] > want.numpy()[:-1]]
        np.testing.assert_array_equal(valid, first)


def test_absorb_commits_only_valid_positions(tmp_path):
    """A pad row of the staged outputs (a repeat of uids[0]) must not
    overwrite the real row's update: only first occurrences commit."""
    store = DiskStore(str(tmp_path / "s"), page_rows=8)
    eng = EmbeddingEngine(R.ctr_table_specs(SMOKE), capacity=6,
                          backend=GatherBackend(staged=True), store=store,
                          device="cpu")
    eng.init(torch.Generator().manual_seed(0))
    uids, valid = eng.host_dedup(np.array([5, 9, 5, 2], np.int32))
    assert list(uids) == [2, 5, 9, 2, 2, 2] and valid.sum() == 3
    rows = torch.arange(6, dtype=torch.float32)[:, None].repeat(1, 16)
    rows[3:] = -7.0                             # pad rows: must not land
    eng._staged_pending = {"sparse": (uids, valid)}
    eng.absorb_staged({"sparse": rows}, {"sparse": rows * 10}, {})
    got, acc = store.gather("sparse", np.array([2, 5, 9], np.int64))
    np.testing.assert_array_equal(got, rows[:3].numpy())
    np.testing.assert_array_equal(acc, rows[:3].numpy() * 10)
    assert eng._staged_pending == {}
    store.close()


@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_predict_on_disk_writes_nothing(placement, tmp_path):
    """Serving between steps overlays the un-absorbed staged outputs and
    writes nothing: the training meters, the pending record and the pages
    stay as they were; training with and without serving is the same."""
    batches, requests = _batches(4), _batches(4, batch=16, seed=2)
    runs = []
    for serve in (False, True):
        tr = build_trainer("baidu-ctr", _tcfg(
            placement, "disk", str(tmp_path / f"s{int(serve)}"), 4),
            seed=5, device="cpu")
        losses = []
        for b, r in zip(batches, requests):
            losses.append(float(tr.train_step(b)))
            if serve:
                st = tr.engine.store
                # the step's read-ahead lands first: the reader thread's
                # page traffic is training's, and may trail the step
                st._read_q.join()
                every = np.arange(SMOKE.rows, dtype=np.int64)
                train_meters = ("page_hits", "page_misses", "pages_evicted",
                                "disk_bytes_read")
                before = ({k: st.stats()[k] for k in train_meters},
                          dict(tr.engine._staged_pending),
                          st.gather("sparse", every, serve=True))
                tr.predict(r)
                # a serve read may evict (and so write behind) a dirty
                # page, with its contents unchanged
                assert {k: st.stats()[k] for k in train_meters} == before[0]
                assert tr.engine._staged_pending.keys() == before[1].keys()
                after = st.gather("sparse", every, serve=True)
                np.testing.assert_array_equal(after[0], before[2][0])
                np.testing.assert_array_equal(after[1], before[2][1])
        runs.append(losses)
        if serve:
            m = tr.serve_metrics()
            assert m["serve_page_hits"] + m["serve_page_misses"] > 0
        tr.close()
    assert runs[0] == runs[1]


@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_disk_matches_reference_on_disk(placement, tmp_path):
    """The port and the JAX reference, both on the DiskStore, 6 steps from
    one state (the reference's pages, dense tower and optimizer state):
    losses and the final rows and accumulators within rtol 1e-4,
    atol 1e-6."""
    jsmoke = jconfigs.get("baidu-ctr").smoke_cfg
    jtr = jbuild_trainer("baidu-ctr", JTrainerConfig(
        n_pod=2, kstep=JKStepConfig(lr=1e-3, k=3, merge="two_phase"),
        sparse=JSparseConfig(lr=0.5, initial_accumulator=0.01),
        placement=placement, capacity=1024,
        cache_rows=1024 if placement == "cached" else None, store="disk",
        spill_dir=str(tmp_path / "ref"), page_rows=256), seed=3)
    rows_np, accum_np = jtr.engine.store.gather(
        "sparse", np.arange(jsmoke.rows, dtype=np.int64))
    tcfg = _tcfg(placement, "disk", str(tmp_path / "port"))
    eng = build_ctr_engine(SMOKE, tcfg, device="cpu")
    state = from_reference(
        jax.device_get(jtr.dense), {"sparse": rows_np},
        {"sparse": accum_np}, jax.device_get(jtr.opt_state), device="cpu",
        backend_state_np=(jax.device_get(jtr.backend_state)
                          if placement == "cached" else None),
        store=eng.store, capacity=eng.capacity)
    tr = HybridTrainer(None, eng, R.ctr_embed_from_workings(SMOKE),
                       R.ctr_hybrid_loss(SMOKE), tcfg, state=state,
                       device="cpu")
    gen = JS.recsys_batches(jsmoke, batch=48, seed=1)
    got, want = [], []
    for _ in range(6):
        b = next(gen)
        want.append(float(jtr.train_step(b)))
        got.append(float(tr.train_step(b)))
    np.testing.assert_allclose(got, want, **CROSS)
    jtr.engine.sync_store(jtr.tables, jtr.sparse_state.accum,
                          jtr.backend_state)
    want_rows = jtr.engine.store.gather(
        "sparse", np.arange(jsmoke.rows, dtype=np.int64))
    rows = _final_rows(tr)["sparse"]
    np.testing.assert_allclose(rows[0], want_rows[0], **CROSS)
    np.testing.assert_allclose(rows[1], want_rows[1], **CROSS)
    assert not np.array_equal(rows[0], rows_np)        # it trained
    jtr.engine.store.close()
    tr.close()


def test_from_reference_fills_the_store(tmp_path):
    """``from_reference(..., store=)`` writes the given rows and
    accumulators into the pages and hands back staging buffers; the
    trainer on it trains as the host store from the same state."""
    rng = np.random.default_rng(8)
    table = (rng.standard_normal((SMOKE.rows, SMOKE.embed_dim)) * 0.05
             ).astype(np.float32)
    accum = (rng.random((SMOKE.rows, SMOKE.embed_dim)) + 0.01).astype(
        np.float32)
    base = build_trainer("baidu-ctr", _tcfg("gather"), seed=1, device="cpu")
    dense = {k: v for k, v in base.dense.items()}
    dense_np = jax.tree_util.tree_map(lambda x: x.numpy().copy(), dense)
    losses = []
    for store in ("host", "disk"):
        tcfg = _tcfg("gather", store, str(tmp_path / "s")
                     if store == "disk" else None)
        eng = build_ctr_engine(SMOKE, tcfg, device="cpu")
        disk = store == "disk"
        state = from_reference(dense_np, {"sparse": table},
                               {"sparse": accum}, device="cpu",
                               store=eng.store if disk else None,
                               capacity=eng.capacity if disk else None)
        if disk:
            assert tuple(state.tables["sparse"].shape) == (1024, 16)
            got = eng.store.gather("sparse", np.arange(SMOKE.rows))
            np.testing.assert_array_equal(got[0], table)
            np.testing.assert_array_equal(got[1], accum)
        tr = HybridTrainer(None, eng, R.ctr_embed_from_workings(SMOKE),
                           R.ctr_hybrid_loss(SMOKE), tcfg, state=state,
                           device="cpu")
        losses.append([float(tr.train_step(b)) for b in _batches(3)])
        tr.close()
    assert losses[0] == losses[1]
    with pytest.raises(ValueError, match="together"):
        from_reference(dense_np, {"sparse": table}, {"sparse": accum},
                       device="cpu", capacity=1024)


def test_metrics_and_close_then_reopen(tmp_path):
    """The page meters ride in ``sparse_metrics``; ``close`` commits
    everything (the last push, the cache's dirty rows) and stops the
    store's threads; a fresh DiskStore on the directory reads the final
    rows."""
    spill = str(tmp_path / "s")
    tr = build_trainer("baidu-ctr", _tcfg("cached", "disk", spill, 4),
                       seed=6, device="cpu")
    for b in _batches(3):
        tr.train_step(b)
    m = tr.sparse_metrics()
    for k in ("page_hit_rate", "pages_evicted", "disk_bytes_read",
              "disk_bytes_written", "page_hit_rate_total"):
        assert k in m
    assert 0.0 <= m["page_hit_rate_total"] <= 1.0
    want = _final_rows(tr)["sparse"]
    tr.close()
    assert not tr.engine.store._writer.is_alive()
    st = DiskStore(spill, page_rows=256)
    st.create_table("sparse", SMOKE.rows, SMOKE.embed_dim, np.float32)
    got = st.gather("sparse", np.arange(SMOKE.rows, dtype=np.int64))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    st.close()


def test_factory_engine_and_launcher_rejections(tmp_path):
    """The reference's rules: page knobs without the disk store, the disk
    store with the routed placement, a staged backend on the host store and
    a plain one on the disk store, the launcher's flags."""
    with pytest.raises(ValueError, match="disk-store knobs"):
        build_trainer("baidu-ctr", TrainerConfig(page_cache_pages=4),
                      device="cpu")
    with pytest.raises(ValueError, match="disk-store knobs"):
        build_trainer("baidu-ctr", TrainerConfig(page_rows=64), device="cpu")
    with pytest.raises(NotImplementedError, match="routed"):
        build_trainer("baidu-ctr", TrainerConfig(
            placement="routed", store="disk",
            spill_dir=str(tmp_path / "r")), device="cpu")
    with pytest.raises(ValueError, match="spill_dir is a disk-store option"):
        build_trainer("baidu-ctr", TrainerConfig(spill_dir=str(tmp_path)),
                      device="cpu")
    specs = R.ctr_table_specs(SMOKE)
    with pytest.raises(ValueError, match="requires store='disk'"):
        EmbeddingEngine(specs, 64, backend=make_backend(
            "gather", staged=True, device="cpu"), device="cpu")
    store = DiskStore(str(tmp_path / "d"))
    with pytest.raises(ValueError, match="requires a staged backend"):
        EmbeddingEngine(specs, 64, store=store, device="cpu")
    store.close()
    with pytest.raises(ValueError, match="requires capacity"):
        make_backend("cached", cache_rows=64, staged=True, device="cpu")
    for flags in (["--store", "disk"], ["--page-rows", "64"],
                  ["--page-cache-pages", "4"]):
        with pytest.raises(ValueError):
            _launch("--arch", "baidu-ctr", "--steps", "1", "--device", "cpu",
                    *flags)


def _launch(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(list(argv))
    return out.getvalue().strip().splitlines()


@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_launcher_disk_prints_the_host_line(placement, tmp_path):
    """``--store disk`` prints the ``--store host`` final line bit for bit
    (all but the steps/s)."""
    common = ["--arch", "baidu-ctr", "--steps", "4", "--device", "cpu",
              "--batch", "32", "--placement", placement, "--k", "2"]
    if placement == "cached":
        common += ["--capacity", "512", "--cache-rows", "600"]
    host = _launch(*common)[-1]
    disk = _launch(*common, "--store", "disk", "--spill-dir",
                   str(tmp_path / "s"), "--page-rows", "128",
                   "--page-cache-pages", "8")[-1]
    cut = lambda line: line[:line.rindex("(")]
    assert host.startswith("final loss ") and cut(disk) == cut(host)
    assert (tmp_path / "s" / "sparse" / "page_000000.npz").exists()
