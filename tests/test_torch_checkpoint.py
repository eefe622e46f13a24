"""The port's checkpointing (A3), on the CPU.

- ``repro_torch.checkpoint``: the cases of ``tests/test_checkpoint.py``
  (atomicity, retention, async failures, wreckage sweeps) on torch trees,
  and the reference's layout and leaf names, so a checkpoint either
  package writes the other reads;
- crash, resume and replay: a run that stops after its checkpoint and is
  resumed in a fresh trainer replays the uninterrupted run's steps bit for
  bit (losses, parameters, moments, tables, accumulators, the cache), for
  ``DenseTrainer`` (GIN, the LM, ``int8_ef``, a checkpoint without the
  residual resumed under ``int8_ef``, ``merge_delay`` 1) and
  ``HybridTrainer`` (gather, cached, the DiskStore);
- the placement, store and backend guards raise, and the GC sweeps stray
  spill pages;
- checkpoints the REFERENCE wrote (a smoke GIN ``DenseTrainer``, a gather
  baidu-ctr ``HybridTrainer``, float32) restore in the port, and the next
  3 steps agree with the reference's within rtol 1e-4, atol 1e-6 (the
  cross-package tolerance of the trainer parity tests: the same float32
  math in other orders).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten_with_names as j_flatten
from repro.core.cache_tier import CacheState as JCacheState
from repro.core.kstep import KStepConfig as JKStepConfig
from repro.core.sparse_optim import SparseAdagradConfig as JSparseConfig
from repro.models import gin as JG
from repro.runtime import factory as jfactory
from repro.runtime import trainer as jtrainer
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    read_manifest, restore_tree, save_tree)
from repro_torch.checkpoint.ckpt import _flatten_with_names
from repro_torch.core.cache_tier import CacheState
from repro_torch.core.kstep import KStepConfig, leaves
from repro_torch.core.sparse_optim import SparseAdagradConfig
from repro_torch.data import synthetic as S
from repro_torch.models import gin as G
from repro_torch.models import transformer as T
from repro_torch.runtime.factory import build_trainer
from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig

CROSS = dict(rtol=1e-4, atol=1e-6)


def tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.int32)}}


def _assert_trees_equal(a, b):
    fa, fb = _flatten_with_names(a), _flatten_with_names(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        y = y if torch.is_tensor(y) else torch.from_numpy(np.asarray(y))
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), k


# ------------------------------------------------------ the manager's cases
def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    save_tree(d, 7, tree(), meta={"k": 20})
    assert latest_step(d) == 7
    _assert_trees_equal(restore_tree(d, 7, tree()), tree())


def test_torn_checkpoint_ignored(tmp_path):
    d = str(tmp_path)
    save_tree(d, 5, tree())
    os.makedirs(os.path.join(d, "step_0000000009.tmp"))
    os.makedirs(os.path.join(d, "step_0000000011"))
    assert latest_step(d) == 5


def test_retention_gc(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep_last=2, save_every=1, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree())
    steps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert steps == ["step_0000000003", "step_0000000004"]


def test_async_save_completes_and_snapshots_first(tmp_path):
    """The async writer writes the tree as it was at ``save``: the caller
    may update its tensors in place right after."""
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep_last=3, save_every=1, async_save=True)
    t = tree()
    mgr.save(1, t)
    t["a"].add_(100.0)
    mgr.wait()
    assert latest_step(d) == 1
    _assert_trees_equal(restore_tree(d, 1, tree()), tree())


def test_shape_mismatch_raises(tmp_path):
    d = str(tmp_path)
    save_tree(d, 1, tree())
    bad = {"a": torch.zeros((3, 3)), "nested": {"b": torch.ones(4)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_tree(d, 1, bad)


def test_manifest_contents(tmp_path):
    d = str(tmp_path)
    path = save_tree(d, 3, tree(), meta={"mesh": [16, 16]})
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 3
    assert man["meta"]["mesh"] == [16, 16]
    assert man["leaves"]["a"] == {"shape": [2, 3], "dtype": "float32"}
    assert man["leaves"]["nested/b"] == {"shape": [4], "dtype": "int32"}
    assert os.path.basename(path) == "step_0000000003"
    assert sorted(os.listdir(path)) == ["arrays_proc0.npz", "manifest.json"]


def test_restore_latest_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1)
    step, t = mgr.restore_latest(tree())
    assert step is None and t is None


def test_async_save_failure_raises_on_wait(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, save_every=1, async_save=True)
    mgr.save(1, tree(), meta={"bad": object()})
    with pytest.raises(TypeError):
        mgr.wait()
    mgr.wait()   # the failure is reported once, then cleared
    assert latest_step(d) is None
    mgr.save(2, tree())
    mgr.wait()
    assert latest_step(d) == 2


def test_async_save_failure_raises_on_next_save(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, save_every=1, async_save=True)
    mgr.save(1, tree(), meta={"bad": object()})
    with pytest.raises(TypeError):
        mgr.save(2, tree(), block=True)
    assert latest_step(d) is None


def test_gc_sweeps_stale_tmp_aside_and_staging_dirs(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "pages_staging_7"))
    old = os.path.join(d, "pages_staging_8")
    os.makedirs(old)
    os.utime(old, (0, 0))            # dead-process wreckage: an hour old
    mgr = CheckpointManager(d, keep_last=2, save_every=1, async_save=False)
    os.makedirs(os.path.join(d, "step_0000000001.tmp"))
    os.makedirs(os.path.join(d, "step_0000000002.old"))
    mgr.save(3, tree())
    left = sorted(os.listdir(d))
    assert left == ["pages_staging_7", "step_0000000003"], left


def test_overwrite_crash_between_renames_keeps_previous(tmp_path):
    d = str(tmp_path)
    save_tree(d, 4, tree())
    save_tree(d, 5, tree())
    final = os.path.join(d, "step_0000000005")
    os.rename(final, final + ".old")
    os.makedirs(final + ".tmp")
    assert latest_step(d) == 4
    _assert_trees_equal(restore_tree(d, 4, tree()), tree())
    t2 = {"a": tree()["a"] * 2, "nested": {"b": tree()["nested"]["b"] * 2}}
    save_tree(d, 5, t2)
    assert latest_step(d) == 5
    assert not os.path.exists(final + ".old")
    assert not os.path.exists(final + ".tmp")
    _assert_trees_equal(restore_tree(d, 5, tree()), t2)


def test_leaf_names_and_bf16_follow_the_reference(tmp_path):
    """The reference's names (sorted dict keys, list indices, ``.field``
    for a NamedTuple, None left out) and a bfloat16 leaf stored as its
    bits with "bfloat16" in the manifest, restored bit for bit."""
    fields = CacheState._fields
    assert fields == JCacheState._fields
    t = {"z": [torch.zeros(1), {"y": torch.ones(2)}], "a": None,
         "c": CacheState(*[torch.full((1,), float(i))
                           for i in range(len(fields))]),
         "w": torch.randn(3, 2).to(torch.bfloat16)}
    jt = {"z": [jnp.zeros(1), {"y": jnp.ones(2)}], "a": None,
          "c": JCacheState(*[jnp.zeros(1) for _ in fields]),
          "w": jnp.zeros((3, 2))}
    assert list(_flatten_with_names(t)) == list(j_flatten(jt)[0])
    assert "c/.slot_uid" in _flatten_with_names(t)
    d = str(tmp_path)
    save_tree(d, 1, t)
    assert read_manifest(d, 1)["leaves"]["w"]["dtype"] == "bfloat16"
    _assert_trees_equal(restore_tree(d, 1, t), t)


# --------------------------------------------------- crash, resume, replay
def _gin_cfg():
    return dataclasses.replace(configs.get("gin-tu").smoke_cfg, d_in=12,
                               n_classes=3)


def _gin_batch(n_pod=2):
    g = S.community_graph(3, 150, 6, 12, 3)
    return {k: np.stack([v] * n_pod) for k, v in
            [("x", g.x), ("edge_src", g.edge_src), ("edge_dst", g.edge_dst),
             ("labels", g.labels)]}


def _dense_case(kind, n=6):
    """(make_trainer(cfg), n batches, train_step kwargs) of a DenseTrainer
    case."""
    if kind == "lm":
        cfg = configs.get("qwen3-14b").smoke_cfg
        gen = S.lm_batches(seed=0, batch=4, seq_len=16, vocab=cfg.vocab)
        batches = [next(gen) for _ in range(n)]
        params = T.init_params(torch.Generator().manual_seed(1), cfg,
                               device="cpu")
        loss = lambda p, b: T.loss_fn(p, b, cfg)      # noqa: E731
        return (lambda tc: DenseTrainer(loss, params, tc, device="cpu"),
                batches, {})
    cfg = _gin_cfg()
    params = G.init_params(torch.Generator().manual_seed(1), cfg,
                           device="cpu")
    loss = lambda p, b: G.loss_fn(p, b, cfg)          # noqa: E731
    return (lambda tc: DenseTrainer(loss, params, tc, device="cpu"),
            [_gin_batch()] * n, {"podded": True})


def _dense_state(tr):
    s = tr.opt_state
    out = {"params": tr.params, "m": s.m, "v_local": s.v_local,
           "v_hat": s.v_hat}
    if s.ef is not None:
        out["ef"] = s.ef
    return out


DENSE_CASES = [("gin", "two_phase", 0, 2), ("lm", "flat", 0, 2),
               ("gin", "int8_ef", 0, 2), ("gin", "two_phase", 1, 4)]


@pytest.mark.parametrize("kind,merge,delay,k", DENSE_CASES)
def test_dense_trainer_crash_resume_replay(kind, merge, delay, k, tmp_path):
    """n_pod 2, 6 steps.  A run saves at step 3 (its ``ckpt_every``), is
    dropped after step 4, and a fresh trainer resumes and replays steps
    4-6: per-step losses and the final state bit for bit.  Under
    ``merge_delay`` 1 (k 4) the save falls before the first merge boundary
    (the delayed merges in flight are not saved, as in the reference, so
    only there can the replay be exact)."""
    stop = 3
    make, batches, kw = _dense_case(kind)

    def tcfg(ckpt=None):
        return TrainerConfig(
            n_pod=2, kstep=KStepConfig(lr=1e-3, k=k, merge=merge),
            merge_delay=delay, ckpt_dir=ckpt, ckpt_every=stop)

    ref = make(tcfg())
    want = [float(ref.train_step(b, **kw)) for b in batches]
    ckpt = str(tmp_path / "ckpt")
    crashed = make(tcfg(ckpt))
    for b in batches[:stop + 1]:
        crashed.train_step(b, **kw)
    crashed.ckpt.wait()
    del crashed
    tr = make(tcfg(ckpt))
    assert tr.resume() and tr.step_num == stop
    assert int(tr.opt_state.step) == stop and not tr._pending_merges
    got = [float(tr.train_step(b, **kw)) for b in batches[stop:]]
    assert got == want[stop:]
    _assert_trees_equal(_dense_state(tr), _dense_state(ref))


def test_dense_merge_delay_resumes_with_an_empty_queue(tmp_path):
    """The reference's ``test_dense_merge_delay_resumes`` (the LM, k 5,
    lr 2e-3): saved after merges were launched, a resume starts with no
    delayed merge in flight and keeps training; two resumes replay the
    same bits."""
    make, batches, kw = _dense_case("lm", n=12)
    tc = TrainerConfig(n_pod=2, kstep=KStepConfig(lr=2e-3, k=5, b1=0.9),
                       merge_delay=1, ckpt_dir=str(tmp_path), ckpt_every=10)
    tr = make(tc)
    for b in batches[:10]:
        tr.train_step(b, **kw)
    tr.ckpt.wait()
    assert len(tr._pending_merges) == 1
    runs = []
    for _ in range(2):
        tr2 = make(tc)
        assert tr2.resume() and tr2.step_num == 10
        assert len(tr2._pending_merges) == 0
        runs.append([float(tr2.train_step(b, **kw)) for b in batches[10:]])
        assert np.all(np.isfinite(runs[-1]))
    assert runs[0] == runs[1]


def test_dense_pre_ef_checkpoint_resumes_under_int8_ef(tmp_path):
    """A checkpoint written without the residual (two_phase) resumes under
    ``int8_ef`` with a fresh zero residual and the saved parameters."""
    make, batches, kw = _dense_case("gin")
    d = str(tmp_path)
    tr = make(TrainerConfig(n_pod=2, kstep=KStepConfig(k=2), ckpt_dir=d,
                            ckpt_every=3))
    for b in batches[:3]:
        tr.train_step(b, **kw)
    tr.ckpt.wait()
    assert not any(k.startswith("ef") for k in read_manifest(d, 3)["leaves"])
    tr2 = make(TrainerConfig(n_pod=2, kstep=KStepConfig(k=2, merge="int8_ef"),
                             ckpt_dir=d, ckpt_every=3))
    assert tr2.resume() and tr2.step_num == 3
    _assert_trees_equal(tr2.params, tr.params)
    assert all(not e.any() for e in leaves(tr2.opt_state.ef))
    assert np.isfinite(float(tr2.train_step(batches[3], **kw)))


SMOKE = configs.get("baidu-ctr").smoke_cfg


def _hybrid_cfg(placement, store="host", spill=None, ckpt=None, every=3,
                cache_rows=1024, page_rows=256):
    return TrainerConfig(
        n_pod=2, kstep=KStepConfig(lr=1e-3, k=2, merge="two_phase"),
        sparse=SparseAdagradConfig(lr=0.5, initial_accumulator=0.01),
        placement=placement, capacity=1024,
        cache_rows=cache_rows if placement == "cached" else None,
        store=store, spill_dir=spill if store == "disk" else None,
        page_rows=page_rows if store == "disk" else None,
        ckpt_dir=ckpt, ckpt_every=every)


def _hybrid_state(tr):
    """Everything a hybrid trainer trains, from the authoritative store or
    placement (the DiskStore synced and read back), as numpy."""
    eng = tr.engine
    out = {"dense": tr.dense, "m": tr.opt_state.m,
           "v_hat": tr.opt_state.v_hat, "v_local": tr.opt_state.v_local,
           "bstate": tr.backend_state}
    if eng.store.kind == "disk":
        eng.sync_store(tr.tables, tr.sparse_state.accum, tr.backend_state)
        for n, s in eng.specs.items():
            rows, acc = eng.store.gather(n, np.arange(s.rows, dtype=np.int64))
            out[f"rows/{n}"], out[f"accum/{n}"] = rows, acc
    else:
        out["tables"], out["accum"] = tr.tables, tr.sparse_state.accum
    return out


@pytest.mark.parametrize("placement,store", [("gather", "host"),
                                             ("cached", "host"),
                                             ("gather", "disk")])
def test_hybrid_trainer_crash_resume_replay(placement, store, tmp_path):
    """baidu-ctr at smoke size, n_pod 2, k 2, 6 steps, a save at step 3
    (the cached placement's 1024-row cache evicting, its state saved
    unflushed; the DiskStore's pages snapshotted into the checkpoint), a
    crash after step 4, a resume in a fresh trainer and the replay of steps
    4-6: losses, dense tree, moments, tables, accumulators and the cache
    state bit for bit against the uninterrupted run."""
    gen = S.recsys_batches(SMOKE, batch=48, seed=1)
    batches = [next(gen) for _ in range(6)]

    def spill(name):
        return str(tmp_path / name) if store == "disk" else None

    ref = build_trainer("baidu-ctr", _hybrid_cfg(placement, store,
                                                 spill("ref")),
                        seed=4, device="cpu")
    want = [float(ref.train_step(b)) for b in batches]
    ckpt = str(tmp_path / "ckpt")
    crashed = build_trainer("baidu-ctr", _hybrid_cfg(
        placement, store, spill("run"), ckpt), seed=4, device="cpu")
    for b in batches[:4]:
        crashed.train_step(b)
    crashed.ckpt.wait()
    if store == "disk":
        assert os.path.isdir(os.path.join(ckpt, "step_0000000003", "pages"))
        crashed.engine.store.close()
    del crashed
    tr = build_trainer("baidu-ctr", _hybrid_cfg(
        placement, store, spill("run"), ckpt), seed=9, device="cpu")
    assert tr.resume() and tr.step_num == 3
    got = [float(tr.train_step(b)) for b in batches[3:]]
    assert got == want[3:]
    assert tr.overflow_dropped == ref.overflow_dropped
    _assert_trees_equal(_hybrid_state(tr), _hybrid_state(ref))
    if placement == "cached":
        assert tr.sparse_metrics()["evictions_total"] > 0
    for t in (ref, tr):
        t.close()


@pytest.mark.parametrize("change,match", [
    (dict(placement="cached"), "GatherBackend"),
    (dict(cache_rows=2048), "cache_rows"),
    (dict(store="disk"), "store"),
    (dict(page_rows=128), "page_rows"),
])
def test_hybrid_resume_guards_raise(change, match, tmp_path):
    """A checkpoint resumed under another placement, cache size, store or
    page size raises, with the reference's message."""
    base = dict(placement="cached" if "cache_rows" in change else "gather",
                store="disk" if "page_rows" in change else "host")
    ckpt = str(tmp_path / "ckpt")
    kw = dict(base, spill=str(tmp_path / "a"), ckpt=ckpt, every=1)
    tr = build_trainer("baidu-ctr", _hybrid_cfg(**kw), device="cpu")
    tr.train_step(next(S.recsys_batches(SMOKE, batch=16, seed=1)))
    tr.ckpt.wait()
    tr.close()
    kw.update(change, spill=str(tmp_path / "b"))
    tr2 = build_trainer("baidu-ctr", _hybrid_cfg(**kw), device="cpu")
    with pytest.raises(ValueError, match=match):
        tr2.resume()
    tr2.close()


def test_gc_sweeps_stray_spill_pages(tmp_path):
    """A DiskStore trainer's checkpoint GC also removes the write-behind
    wreckage (``*.tmp`` page files) of its spill directory."""
    spill = tmp_path / "spill"
    tr = build_trainer("baidu-ctr", _hybrid_cfg(
        "gather", "disk", str(spill), str(tmp_path / "ckpt"), every=1),
        device="cpu")
    table = next(iter(tr.engine.specs))
    stray = spill / table / "page_000001.npz.tmp"
    stray.write_bytes(b"torn")
    tr.train_step(next(S.recsys_batches(SMOKE, batch=16, seed=1)))
    tr.ckpt.wait()
    assert not stray.exists()
    assert latest_step(str(tmp_path / "ckpt")) == 1
    tr.close()


# ------------------------------------------- reference-written checkpoints
def test_reference_gin_checkpoint_restores_in_the_port(tmp_path):
    """A smoke GIN ``DenseTrainer`` checkpoint written by the reference
    (3 steps, float32) resumes the port's, and the next 3 steps agree."""
    cfg = _gin_cfg()
    jcfg = dataclasses.replace(
        jfactory.configs.get("gin-tu").smoke_cfg, d_in=12, n_classes=3)
    d = str(tmp_path)
    kw = dict(lr=1e-3, k=2, b1=0.9)
    jtr = jtrainer.DenseTrainer(
        lambda p, b: JG.loss_fn(p, b, jcfg),
        JG.init_params(jax.random.key(2), jcfg),
        jtrainer.TrainerConfig(n_pod=2, kstep=JKStepConfig(**kw),
                               ckpt_dir=d, ckpt_every=3, ckpt_async=False))
    batch = _gin_batch()
    for _ in range(3):
        jtr.train_step(batch, podded=True)
    tr = DenseTrainer(
        lambda p, b: G.loss_fn(p, b, cfg),
        G.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"),
        TrainerConfig(n_pod=2, kstep=KStepConfig(**kw), ckpt_dir=d,
                      ckpt_every=100),
        device="cpu")
    assert tr.resume() and tr.step_num == 3
    for _ in range(3):
        want = float(jtr.train_step(batch, podded=True))
        got = float(tr.train_step(batch, podded=True))
        np.testing.assert_allclose(got, want, **CROSS)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jtr.params)]
    names = sorted(_flatten_with_names(tr.params))
    flat = _flatten_with_names(tr.params)
    jflat, _ = j_flatten(jtr.params)
    assert names == sorted(jflat) and len(jleaves) == len(names)
    for n in names:
        np.testing.assert_allclose(flat[n].numpy(), np.asarray(jflat[n]),
                                   **CROSS)


def test_reference_hybrid_checkpoint_restores_in_the_port(tmp_path):
    """A gather baidu-ctr ``HybridTrainer`` checkpoint written by the
    reference (3 steps) resumes the port's, and the next 3 steps agree:
    losses, dense tree and tables."""
    d = str(tmp_path)
    jtr = jfactory.build_trainer("baidu-ctr", jtrainer.TrainerConfig(
        n_pod=2, kstep=JKStepConfig(lr=1e-3, k=2, merge="two_phase"),
        sparse=JSparseConfig(lr=0.5, initial_accumulator=0.01),
        placement="gather", capacity=1024, ckpt_dir=d, ckpt_every=3,
        ckpt_async=False))
    gen = S.recsys_batches(SMOKE, batch=48, seed=1)
    batches = [next(gen) for _ in range(6)]
    for b in batches[:3]:
        jtr.train_step(b)
    tr = build_trainer("baidu-ctr", _hybrid_cfg("gather", ckpt=d, every=100),
                       seed=7, device="cpu")
    assert tr.resume() and tr.step_num == 3
    for b in batches[3:]:
        want = float(jtr.train_step(b))
        np.testing.assert_allclose(float(tr.train_step(b)), want, **CROSS)
    for name, got, want in (("dense", tr.dense, jtr.dense),
                            ("tables", tr.tables, jtr.tables)):
        flat, (jflat, _) = _flatten_with_names(got), j_flatten(want)
        assert sorted(flat) == sorted(jflat), name
        for n in flat:
            np.testing.assert_allclose(flat[n].numpy(), np.asarray(jflat[n]),
                                       **CROSS)
