"""The port's cached placement (``repro_torch.core.cache_tier``) against the
reference's (``repro.core.cache_tier``), on the CPU.

Inputs are numpy, from fixed seeds; both sides start from one state.

Tolerances, and why:
  - The backend, pull by pull and push by push: EXACT, against the
    reference's fused path.  The dedup, the hash map, the victim order (the
    port's stable sort = the reference's ``top_k`` ties), the LFU counters
    (sums of whole numbers) and the meters are exact by construction; the
    rows only move, and the push's ``(delta, g2)`` are bit-equal to the
    reference's (the port rounds ``a + g^2`` once and takes a correctly
    rounded root, as XLA does there).
  - Within the port: the cached full mirror is bit-identical to the gather
    placement; ``lookup`` changes no bit of the state.
  - The trainer, 10 steps from one warm state: losses within rtol = 1e-4,
    atol = 1e-6 (as ``tests/test_torch_train.py`` holds the gather slice:
    the dense tower's sums run in other orders); the cache's integer state,
    its hit rate, evictions and byte meters are equal.
"""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.cache_tier import CachedBackend as JCachedBackend
from repro.core.kstep import KStepConfig as JKStepConfig
from repro.core.sparse_optim import SparseAdagrad as JSparseAdagrad
from repro.core.sparse_optim import SparseAdagradConfig as JSparseConfig
from repro.data import synthetic as JS
from repro.runtime.factory import build_trainer as jbuild_trainer
from repro.runtime.online import fit_online as jfit_online
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.core import embedding_backend as tbe
from repro_torch.core.cache_tier import CachedBackend, CacheState
from repro_torch.core.embedding_engine import EmbeddingEngine
from repro_torch.core.kstep import KStepConfig
from repro_torch.core.sparse_optim import SparseAdagrad, SparseAdagradConfig
from repro_torch.data import synthetic as S
from repro_torch.interop import from_reference
from repro_torch.kernels import hash_map as hm
from repro_torch.kernels import ops
from repro_torch.launch import train as launch
from repro_torch.models import recsys as R
from repro_torch.runtime.factory import build_ctr_engine, build_ctr_server
from repro_torch.runtime.factory import build_trainer
from repro_torch.runtime.online import fit_online
from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

torch.set_num_threads(1)

SMOKE = configs.get("baidu-ctr").smoke_cfg
LR, EPS = 0.5, 1e-10


def _state_np(state):
    return {f: np.asarray(v) for f, v in state._asdict().items()}


def _assert_state_equal(got: CacheState, want, what=""):
    w = _state_np(jax.device_get(want))
    assert set(got._fields) == set(w)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), w[f],
                                      err_msg=f"{what} {f}")


def _clone_state(s):
    return CacheState(*[x.clone() for x in s])


def _ids(rng, rows, n):
    """Zipf-skewed ids: a hot head that hits, a long tail that misses."""
    return ((rng.zipf(1.3, n) - 1) % rows).astype(np.int32)


def _row_grads(rng, uids, dim):
    """Seeded working-row gradients: zero at the pads (no id slot maps to
    one), nonzero at the drop row (the push must discard it)."""
    cap = uids.shape[0]
    g = rng.standard_normal((cap + 1, dim)).astype(np.float32)
    n_real = np.unique(uids).size
    g[n_real:cap] = 0.0
    return g


def _run_pair(seed, push, steps=32, rows=3000, dim=8, cap=64, C=96,
              decay=0.9, n_ids=150):
    """Pulls (and pushes) through both backends from one state, checked
    after every step; returns the final states.  The reference runs its
    fused path (the Pallas probe, cached gather and cached push, in
    interpret mode): the kernels the port's CUDA kernels replace.  (Its
    unfused push, jitted whole, rounds ``a + g^2`` twice, so it can differ
    from its fused push by an ulp of ``delta``.)"""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    accum = (rng.random((rows, dim)) + 0.01).astype(np.float32)
    jcb = JCachedBackend(cache_rows=C, decay=decay, fused=True)
    jpull = jax.jit(functools.partial(jcb.pull, capacity=cap))
    jopt = JSparseAdagrad(JSparseConfig(lr=LR, eps=EPS))
    jpush = jax.jit(lambda t, a, s, ws, g: jcb.push(t, a, s, ws, g, jopt))
    jt, ja = jnp.asarray(table), jnp.asarray(accum)
    js = jcb.init_state(jt)

    cb = CachedBackend(cache_rows=C, decay=decay, device="cpu")
    opt = SparseAdagrad(SparseAdagradConfig(lr=LR, eps=EPS))
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    s = cb.init_state(t)
    _assert_state_equal(s, js, "init")
    for step in range(steps):
        ids = _ids(rng, rows, n_ids)
        jws, jt, ja, js = jpull(jt, ja, js, flat_ids=jnp.asarray(ids))
        ws, t, a, s = cb.pull(t, a, s, torch.from_numpy(ids), cap)
        for f, got, want in zip(ws._fields, ws, jws):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"step {step} ws.{f}")
        _assert_state_equal(s, js, f"step {step} pull")
        if push:
            g = _row_grads(rng, np.asarray(jws.uids), dim)
            jt, ja, js = jpush(jt, ja, js, jws, jnp.asarray(g))
            t, a, s = cb.push(t, a, s, ws, torch.from_numpy(g), opt)
            _assert_state_equal(s, js, f"step {step} push")
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    return s, js


@pytest.mark.parametrize("seed", [0, 10])
def test_pulls_match_reference_exactly(seed):
    """32 pulls with evictions and rebuilds: the working sets, every
    CacheState field and the host table and accumulator equal."""
    ops.reset_launches()
    s, _ = _run_pair(seed, push=False)
    assert float(s.evictions) > 0 and float(s.rebuilds) >= 1
    # n_occupied + capacity > 3H/4 forced the rebuilds (H = 512, cap = 64)
    assert hm.hash_table_size(96) == 512
    assert ops.launches["hash_lookup_ref"] == 32
    assert ops.launches["gather_rows_cached_ref"] == 32


@pytest.mark.parametrize("seed", [1, 11])
def test_pulls_and_pushes_match_reference_bit_for_bit(seed):
    """The same run with seeded pushes: dirty rows spill to the host table
    on eviction, and everything stays bit-equal."""
    ops.reset_launches()
    s, _ = _run_pair(seed, push=True, steps=30)
    assert float(s.evictions) > 0 and float(s.rebuilds) >= 1
    assert float(s.bytes_d2h) > 0                    # dirty rows spilled
    assert bool(s.dirty.any())
    n = 30
    assert ops.launches["hash_lookup_ref"] == 2 * n            # pull, push
    assert ops.launches["gather_rows_cached_ref"] == 2 * n     # rows, accum
    assert ops.launches["sparse_adagrad_cached_apply_ref"] == n


@pytest.mark.parametrize("C,D,cap", [(40, 16, 32), (129, 100, 257),
                                     (7, 3, 1)])
def test_gather_with_drop_row_matches_pallas_gather_and_a_zero_row(C, D,
                                                                   cap):
    """``ref.gather_rows_cached_ref(..., drop_row=True)`` (the CPU path of
    the cached pull and lookup) against the reference's
    ``gather_rows_cached_pallas(interpret=True)`` with a zero row appended
    (the reference's pull appends it outside the kernel): exact."""
    from repro.kernels.sparse_adagrad import gather_rows_cached_pallas
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(C)
    rows = rng.standard_normal((C, D)).astype(np.float32)
    slots = rng.integers(0, C, cap).astype(np.int32)
    got = tref.gather_rows_cached_ref(torch.from_numpy(rows),
                                      torch.from_numpy(slots), drop_row=True)
    want = np.asarray(gather_rows_cached_pallas(
        jnp.asarray(rows), jnp.asarray(slots), interpret=True))
    want = np.concatenate([want, np.zeros((1, D), np.float32)])
    assert got.shape == (cap + 1, D)
    np.testing.assert_array_equal(got.numpy(), want)
    ops.reset_launches()
    again = ops.gather_rows_cached(torch.from_numpy(rows),
                                   torch.from_numpy(slots), drop_row=True)
    assert torch.equal(again, got)
    assert ops.launches["gather_rows_cached_ref"] == 1


def test_decay_one_ties_break_as_the_reference():
    """Plain LFU (decay 1.0): whole-number scores tie often; the victim
    order must still be the reference's."""
    _run_pair(2, push=True, steps=12, decay=1.0, C=64, cap=64)


def test_full_mirror_is_bit_identical_to_gather():
    """cache_rows >= rows: no eviction, and every pull, push and flushed
    table equals the gather placement's bit for bit."""
    rng = np.random.default_rng(3)
    rows, dim, cap = 64, 8, 64
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    opt = SparseAdagrad(SparseAdagradConfig(lr=0.1))
    gb = tbe.GatherBackend(fused=True)
    cb = CachedBackend(cache_rows=rows, device="cpu")
    tg, tc = torch.from_numpy(table.copy()), cb.prepare(
        torch.from_numpy(table.copy()))
    ag, ac = torch.full((rows, dim), 0.1), torch.full((rows, dim), 0.1)
    sg, sc = gb.init_state(tg), cb.init_state(tc)
    for _ in range(6):
        ids = torch.from_numpy(rng.integers(0, rows, 50).astype(np.int32))
        wg, tg, ag, sg = gb.pull(tg, ag, sg, ids, cap)
        wc, tc, ac, sc = cb.pull(tc, ac, sc, ids, cap)
        for x, y in zip(wg, wc):
            assert torch.equal(x, y)
        g = torch.from_numpy(_row_grads(rng, wg.uids.numpy(), dim))
        tg, ag, sg = gb.push(tg, ag, sg, wg, g, opt)
        tc, ac, sc = cb.push(tc, ac, sc, wc, g, opt)
        ft, fa = tc.clone(), ac.clone()
        cb.flush(ft, fa, _clone_state(sc))
        assert torch.equal(ft, tg) and torch.equal(fa, ag)
    assert float(sc.evictions) == 0.0 and float(sc.bytes_d2h) == 0.0


def test_lookup_mutates_nothing_and_serves_fresh_rows():
    """After pulls and pushes (dirty rows in the cache, spilled rows in the
    table), lookup serves exactly the rows a pull would serve (the flushed
    table's rows) and leaves every bit of state, table and accumulator as
    it was."""
    rng = np.random.default_rng(4)
    rows, dim, cap, C = 2000, 8, 64, 96
    cb = CachedBackend(cache_rows=C, decay=0.9, device="cpu")
    opt = SparseAdagrad(SparseAdagradConfig(lr=LR))
    t = torch.from_numpy(rng.standard_normal((rows, dim)).astype(np.float32))
    a = torch.full((rows, dim), 0.01)
    s = cb.init_state(t)
    for _ in range(12):
        ws, t, a, s = cb.pull(t, a, s, torch.from_numpy(_ids(rng, rows, 150)),
                              cap)
        g = torch.from_numpy(_row_grads(rng, ws.uids.numpy(), dim))
        t, a, s = cb.push(t, a, s, ws, g, opt)
    assert float(s.bytes_d2h) > 0 and bool(s.dirty.any())
    before = (_clone_state(s), t.clone(), a.clone())
    ids = torch.from_numpy(_ids(rng, rows, 150))
    lws, aux = cb.lookup(t, a, s, ids, cap)
    for x, y in zip(s, before[0]):
        assert torch.equal(x, y)
    assert torch.equal(t, before[1]) and torch.equal(a, before[2])
    ft, fa, _ = cb.flush(t.clone(), a.clone(), _clone_state(s))
    want, *_ = tbe.GatherBackend().pull(ft, fa, (), ids, cap)
    for x, y in zip(lws, want):
        assert torch.equal(x, y)
    slot = ops.hash_lookup(s.key_tab, s.slot_tab, s.slot_uid, lws.uids)
    valid = torch.cat([torch.ones(1, dtype=torch.bool),
                       lws.uids[1:] > lws.uids[:-1]])
    assert float(aux["serve_misses"]) == float((valid & (slot < 0)).sum())
    assert 0 < float(aux["serve_misses"]) < float(valid.sum())
    assert float(aux["serve_lookups"]) == 150 - float(lws.n_dropped)


def test_flush_writes_dirty_rows_back():
    rng = np.random.default_rng(5)
    rows, dim, cap = 50, 4, 16
    cb = CachedBackend(cache_rows=32, device="cpu")
    opt = SparseAdagrad(SparseAdagradConfig(lr=LR))
    t0 = torch.from_numpy(rng.standard_normal((rows, dim)).astype(np.float32))
    t, a = t0.clone(), torch.full((rows, dim), 0.01)
    s = cb.init_state(t)
    ws, t, a, s = cb.pull(t, a, s, torch.tensor([3, 7, 7, 11],
                                                dtype=torch.int32), cap)
    t, a, s = cb.push(t, a, s, ws, torch.ones((cap + 1, dim)), opt)
    assert torch.equal(t, t0)                      # write-through to cache only
    assert int(s.dirty.sum()) == 3
    t, a, s = cb.flush(t, a, s)
    for u in (3, 7, 11):
        slot = int(torch.nonzero(s.slot_uid == u))
        assert torch.equal(t[u], s.rows[slot]) and torch.equal(a[u],
                                                               s.accum[slot])
        assert not torch.equal(t[u], t0[u])
    assert not bool(s.dirty.any())
    assert float(s.bytes_d2h) == 3 * dim * (4 + 4)
    untouched = torch.ones(rows, dtype=torch.bool)
    untouched[[3, 7, 11]] = False
    assert torch.equal(t[untouched], t0[untouched])


def test_stats_and_derived_cache_stats():
    """stats reads the six counters; an interval with no lookups reports a
    hit rate of 0.0 (not 1.0), as the reference's derive_cache_stats."""
    from repro.core.embedding_engine import EmbeddingEngine as JEngine

    cb = CachedBackend(cache_rows=16, device="cpu")
    t = torch.zeros((40, 2))
    s = cb.init_state(t)
    assert cb.stats(s) == dict.fromkeys(
        ("lookups", "fetched", "evictions", "rebuilds", "bytes_h2d",
         "bytes_d2h"), 0.0)
    ws, t, _, s = cb.pull(t, torch.zeros((40, 2)), s,
                          torch.tensor([1, 2, 2, 5], dtype=torch.int32), 8)
    st = cb.stats(s)
    assert st["lookups"] == 4.0 and st["fetched"] == 3.0
    assert st["bytes_h2d"] == 3 * 2 * 8
    zero = {"lookups": 0.0, "fetched": 0.0, "evictions": 0.0,
            "bytes_h2d": 0.0, "bytes_d2h": 0.0}
    for counters in (zero, st, {}):
        assert EmbeddingEngine.derive_cache_stats(counters) == \
            JEngine.derive_cache_stats(counters)
    assert EmbeddingEngine.derive_cache_stats(zero)["cache_hit_rate"] == 0.0
    assert EmbeddingEngine.derive_cache_stats(st)["cache_hit_rate"] == 0.25


# ------------------------------------------------------------ the trainer
def _tcfg(cls, kcls, **kw):
    return cls(n_pod=2, kstep=kcls(k=3), capacity=256, cache_rows=384,
               placement="cached", fused_kernels=True, log_every=1, **kw)


def test_trainer_matches_reference_from_a_warm_cache():
    """The reference trains 4 steps (the cache warms up, evicts and holds
    dirty rows), then both continue 10 steps from its exported state."""
    jtr = jbuild_trainer("baidu-ctr", _tcfg(JTrainerConfig, JKStepConfig),
                         seed=3)
    jgen = JS.recsys_batches(jconfigs.get("baidu-ctr").smoke_cfg, batch=32,
                             seed=5)
    for _ in range(4):
        jtr.train_step(next(jgen))
    state = from_reference(
        jax.device_get(jtr.dense), jax.device_get(jtr.tables),
        jax.device_get(jtr.sparse_state.accum),
        jax.device_get(jtr.opt_state), device="cpu",
        backend_state_np=jax.device_get(jtr.backend_state))
    tcfg = _tcfg(TrainerConfig, KStepConfig)
    tr = HybridTrainer(None, build_ctr_engine(SMOKE, tcfg, device="cpu"),
                       R.ctr_embed_from_workings(SMOKE),
                       R.ctr_hybrid_loss(SMOKE), tcfg, state=state,
                       device="cpu")
    _assert_state_equal(tr.backend_state["sparse"],
                        jtr.backend_state["sparse"], "imported")
    batches = [next(jgen) for _ in range(10)]
    jh, jauc = jfit_online(jtr, iter(batches), 10, window=5)
    ops.reset_launches()
    h, auc = fit_online(tr, iter([{k: np.asarray(v) for k, v in b.items()}
                                  for b in batches]), 10, window=5)
    tol = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose([r["loss"] for r in h],
                               [r["loss"] for r in jh[-10:]], **tol)
    np.testing.assert_allclose(auc, jauc, **tol)
    for key in ("cache_hit_rate", "evictions", "cache_bytes_h2d",
                "cache_bytes_d2h", "cache_hit_rate_total", "evictions_total"):
        assert [r[key] for r in h] == [r[key] for r in jh[-10:]], key
    assert h[-1]["evictions_total"] > 0 and h[-1]["cache_bytes_d2h_total"] > 0
    js = jax.device_get(jtr.backend_state["sparse"])
    got = tr.backend_state["sparse"]
    for f in ("slot_uid", "key_tab", "slot_tab", "n_occupied", "freq",
              "dirty", "lookups", "fetched", "evictions", "rebuilds",
              "bytes_h2d", "bytes_d2h"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("rows", "accum"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(js, f)), err_msg=f,
                                   **tol)
    # one predict and one pull, probe and gather each, and one push per step
    assert ops.launches["hash_lookup_ref"] == 10 * 3
    assert ops.launches["gather_rows_cached_ref"] == 10 * 3
    assert ops.launches["sparse_adagrad_cached_apply_ref"] == 10


def test_serving_on_the_cached_placement_changes_nothing():
    """A co-located server between steps: the losses and the final state
    are bit-identical to a run without it; serve_hit_rate is reported."""
    def run(serve):
        tcfg = TrainerConfig(n_pod=2, kstep=KStepConfig(k=2), capacity=256,
                             cache_rows=300, placement="cached", log_every=1)
        tr = build_trainer("baidu-ctr", tcfg, seed=7, device="cpu")
        srv = build_ctr_server(tr, max_batch=16) if serve else None
        gen = S.recsys_batches(SMOKE, batch=32, seed=5)
        serve_gen = S.recsys_batches(SMOKE, batch=16, seed=2)
        losses = []
        for _ in range(6):
            if srv is not None:
                srv.submit_batch(next(serve_gen))
            losses.append(tr.train_step(next(gen)))
            if srv is not None:
                assert srv.drain() == 16
        return tr, torch.stack(losses)

    a, la = run(False)
    b, lb = run(True)
    assert torch.equal(la, lb)
    assert torch.equal(a.tables["sparse"], b.tables["sparse"])
    for x, y in zip(a.backend_state["sparse"], b.backend_state["sparse"]):
        assert torch.equal(x, y)
    m = b.serve_metrics()
    assert 0.0 < m["serve_hit_rate"] <= 1.0
    assert m["serve_misses"] <= m["serve_lookups"]
    assert "serve_hit_rate" not in a.serve_metrics()


def test_factory_rules():
    """An explicit undersized cache_rows raises; the default is the
    capacity; the cached trainer's history carries the cache stats per
    interval and the engine flushes and exports."""
    with pytest.raises(ValueError, match="cache_rows"):
        build_trainer("baidu-ctr", TrainerConfig(
            placement="cached", capacity=256, cache_rows=128), device="cpu")
    tr = build_trainer("baidu-ctr", TrainerConfig(
        placement="cached", capacity=256, log_every=2, n_pod=2,
        kstep=KStepConfig(k=2)), device="cpu")
    assert tr.engine.backend.cache_rows == tr.engine.capacity == 256
    m = tr.sparse_metrics()                       # idle: no lookups yet
    assert m["cache_hit_rate"] == m["cache_hit_rate_total"] == 0.0
    hist = tr.fit(S.recsys_batches(SMOKE, batch=32, seed=3), 6)
    assert [r["step"] for r in hist] == [2, 4, 6]
    assert sum(r["evictions"] for r in hist) == hist[-1]["evictions_total"]
    assert sum(r["cache_bytes_h2d"] for r in hist) == \
        hist[-1]["cache_bytes_h2d_total"]
    assert tr.sparse_metrics() == tr.sparse_metrics()        # a pure read
    tables, accum, states = tr.engine.flush(tr.tables, tr.sparse_state.accum,
                                            tr.backend_state)
    assert not bool(states["sparse"].dirty.any())
    assert tr.engine.export(tables)["sparse"] is tables["sparse"]
    assert tr.engine.cache_stats(states)["evictions"] == \
        hist[-1]["evictions_total"]
    for bad in ({"staged": True}, {}):
        with pytest.raises((NotImplementedError, TypeError)):
            tbe.make_backend("cached", device="cpu", **bad)


def test_launcher_runs_the_cached_placement():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(["--arch", "baidu-ctr", "--steps", "4", "--device",
                     "cpu", "--placement", "cached", "--capacity", "1024",
                     "--cache-rows", "1536", "--batch", "64"])
    last = out.getvalue().strip().splitlines()[-1]
    assert last.startswith("final loss ") and "placement cached" in last
    assert np.isfinite(float(last.split()[2]))
    assert "cache_hit_rate" in last and "evictions" in last
    assert "cache_hit" in out.getvalue().strip().splitlines()[-2]
