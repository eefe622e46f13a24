"""The port's DIN, DIEN and two-tower retrieval against the reference, on
the CPU.

Each check starts both packages from one state (the reference's dense
parameters and trainer state, exported as numpy and loaded through
``repro_torch.interop.from_reference``) and feeds them the same numpy
inputs: the synthetic streams are byte-identical copies.  The reference is
run on its gather placement; its routed cases fail (ROADMAP.md §C).

Tolerances, and why (float32 throughout):
  - the models' pieces (the GRU and AUGRU, the attention, the forwards,
    the losses, the retrieval scores): rtol = atol = 1e-5, the matmuls sum
    in other orders (the GRU's input projection is one product over T in
    the port, one a step in the reference);
  - the working-set adapters against the direct takes and bag: bit-equal
    forward (a bag of one id is the row itself; the mean bag is the same
    plain version), gradients within 1e-6 of the reference's vjp;
  - training at smoke size: losses and the online AUC within rtol 1e-5,
    atol 1e-6; dense parameters, tables, accumulators and the Adam moments
    within rtol 1e-4, atol 1e-6 (``tests/test_torch_train.py``'s SLICE);
    two-tower's within atol 1e-5: its logits are divided by the temperature
    0.05, so its gradients carry 20 times the float32 noise of the others
    (one element of a 64-element leaf misses atol 1e-6 by 3.6e-6).
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.kstep import KStepConfig as JKStepConfig
from repro.core.sparse_optim import SparseAdagradConfig as JSparseConfig
from repro.data import synthetic as JS
from repro.models import recsys as JR
from repro.runtime.factory import build_ctr_server as jbuild_server
from repro.runtime.factory import build_trainer as jbuild_trainer
from repro.runtime.metrics import auc as jauc
from repro.runtime.online import fit_online as jfit_online
from repro.runtime.serve_ctr import requests_from_batch as jrequests_from_batch
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.core.kstep import KStepConfig, leaves
from repro_torch.core.sparse_optim import SparseAdagradConfig
from repro_torch.data import synthetic as S
from repro_torch.interop import from_reference
from repro_torch.kernels import ops
from repro_torch.launch import train as launch
from repro_torch.models import recsys as R
from repro_torch.runtime import factory
from repro_torch.runtime.factory import build_ctr_server, build_trainer
from repro_torch.runtime.metrics import auc
from repro_torch.runtime.online import fit_online
from repro_torch.runtime.serve_ctr import requests_from_batch
from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

torch.set_num_threads(1)

ARCHS = ("din", "dien", "two-tower-retrieval")
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
TWO_TOWER_STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def _smoke(arch):
    return configs.get(arch).smoke_cfg, jconfigs.get(arch).smoke_cfg


def _dense(arch, seed=0):
    """The reference's dense tree for the smoke config, in both packages."""
    cfg, jcfg = _smoke(arch)
    init = (JR.two_tower_init_dense if arch == "two-tower-retrieval"
            else JR.din_init_dense)
    dense_np = jax.device_get(init(jax.random.key(seed), jcfg))
    return dense_np, from_reference({"d": dense_np}, {}, {},
                                    device="cpu").dense["d"]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# -------------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    """``configs.get`` resolves the A9 archs to the reference's values,
    field by field."""
    got, want = configs.get(arch), jconfigs.get(arch)
    assert (got.name, got.family, got.source) == (want.name, want.family,
                                                 want.source)
    for which in ("model_cfg", "smoke_cfg"):
        g, w = getattr(got, which), getattr(want, which)
        fields = [f.name for f in dataclasses.fields(w) if f.name != "dtype"]
        assert fields == [f.name for f in dataclasses.fields(g)
                          if f.name != "dtype"]
        for f in fields:
            assert getattr(g, f) == getattr(w, f), (which, f)
        assert g.dtype == torch.float32
    assert got.shapes.keys() == want.shapes.keys()
    for k in got.shapes:
        assert (got.shapes[k].kind, got.shapes[k].dims) == (
            want.shapes[k].kind, want.shapes[k].dims)
    # gin-tu, unregistered until A10e, now resolves to the reference's
    assert configs.get("gin-tu").family == jconfigs.get("gin-tu").family
    with pytest.raises(KeyError, match="not in the port"):
        configs.get("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_streams_are_byte_identical(arch):
    cfg, jcfg = _smoke(arch)
    got = S.recsys_batches(cfg, batch=48, seed=4, worker=1)
    want = JS.recsys_batches(jcfg, batch=48, seed=4, worker=1)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(TypeError, match="no synthetic stream"):
        S.recsys_batches(object(), batch=4)


# ------------------------------------------------------------- the pieces
@pytest.mark.parametrize("which,att", [("gru", None), ("augru", None),
                                       ("augru", "random"), ("augru", "zeros"),
                                       ("augru", "ones")])
def test_gru_scan_matches_the_reference(which, att):
    """``_gru_scan`` over T as the reference's ``lax.scan``: the GRU, the
    AUGRU with attention, zero attention freezing the state and full
    attention giving the plain GRU."""
    dense_np, dense = _dense("dien")
    h = dense_np[which]["wh"].shape[0]
    d_in = dense_np[which]["wx"].shape[0]
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((9, 5, d_in)).astype(np.float32)
    h0 = rng.standard_normal((5, h)).astype(np.float32)
    a = None
    if att is not None:
        a = {"random": rng.random((9, 5)), "zeros": np.zeros((9, 5)),
             "ones": np.ones((9, 5))}[att].astype(np.float32)
    hs, final = R._gru_scan(dense[which], _t(xs), _t(h0),
                            att=None if a is None else _t(a))
    jhs, jfinal = JR._gru_scan(dense_np[which], xs, h0,
                               att=None if a is None else jnp.asarray(a))
    assert hs.shape == (9, 5, h) and final.shape == (5, h)
    _close(hs, jhs)
    _close(final, jfinal)
    assert torch.equal(hs[-1], final)
    if att == "zeros":
        np.testing.assert_allclose(final.numpy(), h0, atol=1e-6)
    if att == "ones":
        plain, _ = R._gru_scan(dense[which], _t(xs), _t(h0))
        torch.testing.assert_close(hs, plain, rtol=0, atol=1e-6)


def _din_batch(cfg, B, seed):
    return next(S.din_batches(seed=seed, batch=B, vocab=cfg.item_vocab,
                              seq_len=cfg.seq_len))


def _tables(vocab, dim, seed=1, scale=0.1):
    return (np.random.default_rng(seed).standard_normal((vocab, dim))
            * scale).astype(np.float32)


def test_din_attention_mask_matches_the_reference():
    """The masked softmax: the port's weights equal the reference's, masked
    positions get none, and changing an id there changes nothing."""
    cfg, jcfg = _smoke("din")
    dense_np, dense = _dense("din")
    table = _tables(cfg.item_vocab, cfg.embed_dim)
    b = _din_batch(cfg, 6, seed=3)
    emb = R.din_embed_batch({"items": _t(table)}, {k: _t(v) for k, v in
                                                   b.items()}, cfg)
    jemb = JR.din_embed_batch({"items": table}, b, jcfg)
    att = R.din_attention(dense, emb["hist"], emb["target"],
                          _t(b["hist_mask"]))
    jatt = JR.din_attention(dense_np, jemb["hist"], jemb["target"],
                            b["hist_mask"])
    _close(att, jatt)
    assert not att[torch.from_numpy(b["hist_mask"]) == 0].any()
    torch.testing.assert_close(att.sum(-1), torch.ones(6))
    # an id at a masked position does not reach the output
    for arch in ("din", "dien"):
        cfg_a = _smoke(arch)[0]
        dense_a = _dense(arch)[1]
        b1 = {k: _t(v) for k, v in b.items()}
        masked = np.argwhere(b["hist_mask"] == 0)
        hist2 = b["hist_ids"].copy()
        for i, j in masked:
            hist2[i, j] = (hist2[i, j] + 13) % cfg.item_vocab
        b2 = dict(b1, hist_ids=_t(hist2))
        outs = [R.din_forward_from_emb(
            dense_a, R.din_embed_batch({"items": _t(table)}, bb, cfg_a), bb,
            cfg_a) for bb in (b1, b2)]
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_the_reference(arch):
    """The forward of DIN, DIEN and two-tower, and each loss adapter
    (``predict=True`` too), from one state and one batch."""
    cfg, jcfg = _smoke(arch)
    dense_np, dense = _dense(arch, seed=2)
    table = _tables(cfg.item_vocab, cfg.embed_dim, seed=4, scale=0.5)
    batch = next(S.recsys_batches(cfg, batch=24, seed=8))
    tb = {k: _t(v) for k, v in batch.items()}
    if arch == "two-tower-retrieval":
        emb = R.two_tower_embed_batch({"items": _t(table)}, tb, cfg)
        jemb = JR.two_tower_embed_batch({"items": table}, batch, jcfg)
        u, v = R.two_tower_forward_from_emb(dense, emb, tb, cfg)
        ju, jv = JR.two_tower_forward_from_emb(dense_np, jemb, batch, jcfg)
        _close(u, ju)
        _close(v, jv)
        np.testing.assert_allclose(torch.linalg.norm(u, dim=-1).numpy(), 1,
                                   rtol=1e-5)
        loss_of, jloss_of = R.two_tower_hybrid_loss, JR.two_tower_hybrid_loss
    else:
        emb = R.din_embed_batch({"items": _t(table)}, tb, cfg)
        jemb = JR.din_embed_batch({"items": table}, batch, jcfg)
        _close(R.din_forward_from_emb(dense, emb, tb, cfg),
               JR.din_forward_from_emb(dense_np, jemb, batch, jcfg))
        loss_of, jloss_of = R.din_hybrid_loss, JR.din_hybrid_loss
    for k in emb:
        _close(emb[k], jemb[k], rtol=0, atol=1e-7)
    for predict in (False, True):
        got = loss_of(cfg)(dense, emb, tb, predict=predict)
        want = jloss_of(jcfg)(dense_np, jemb, batch, predict=predict)
        _close(got, want)
    scores = loss_of(cfg)(dense, emb, tb, predict=True)
    if arch == "two-tower-retrieval":
        assert scores.abs().max() <= 1 + 1e-6
    else:
        assert ((scores > 0) & (scores < 1)).all()


@pytest.mark.parametrize("pool", [4096, 7])
def test_two_tower_loss_with_and_without_logq(pool):
    """The sampled softmax at the config's pool (every in-batch item) and at
    a pool below the batch (rows past it score their positive alone), with
    and without ``sample_logq``; a positive logQ on the negatives lowers the
    loss in both packages."""
    cfg, jcfg = _smoke("two-tower-retrieval")
    cfg, jcfg = (dataclasses.replace(c, neg_pool=pool) for c in (cfg, jcfg))
    dense_np, dense = _dense("two-tower-retrieval", seed=3)
    rng = np.random.default_rng(5)
    emb_np = {"user": rng.standard_normal((20, cfg.embed_dim)).astype(
        np.float32), "item": rng.standard_normal((20, cfg.embed_dim)).astype(
        np.float32)}
    emb = {k: _t(v) for k, v in emb_np.items()}
    logq = rng.random(20).astype(np.float32)
    losses = []
    for extra in ({}, {"sample_logq": logq}):
        got = R.two_tower_loss(dense, emb, {k: _t(v) for k, v in
                                            extra.items()}, cfg)
        want = JR.two_tower_loss(dense_np, emb_np, extra, jcfg)
        _close(got, want)
        assert torch.isfinite(got)
        losses.append(float(got))
    assert losses[1] < losses[0]
    # the gradients through the pool's mask are finite
    e = {k: v.clone().requires_grad_(True) for k, v in emb.items()}
    R.two_tower_loss(dense, e, {}, cfg).backward()
    jg = jax.grad(lambda x: JR.two_tower_loss(dense_np, x, {}, jcfg))(emb_np)
    for k in e:
        _close(e[k].grad, jg[k], rtol=1e-4, atol=1e-6)


def test_two_tower_score_candidates_matches_the_reference():
    cfg, jcfg = _smoke("two-tower-retrieval")
    dense_np, dense = _dense("two-tower-retrieval", seed=6)
    table = _tables(cfg.item_vocab, cfg.embed_dim, seed=2, scale=1.0)
    rng = np.random.default_rng(9)
    user = rng.standard_normal((3, cfg.embed_dim)).astype(np.float32)
    cand = rng.permutation(cfg.item_vocab)[:200].astype(np.int32)
    got = R.two_tower_score_candidates(dense, {"items": _t(table)}, _t(user),
                                       _t(cand), cfg)
    want = JR.two_tower_score_candidates(dense_np, {"items": table}, user,
                                         cand, jcfg)
    assert got.shape == (3, 200)
    _close(got, want)
    assert got.abs().max() <= 1 + 1e-6


def test_tower_gradient_is_finite_at_the_drop_row():
    """A dropped id reads the zero drop row: the tower's guard keeps the
    gradient finite there, as the reference's does."""
    cfg, jcfg = _smoke("two-tower-retrieval")
    dense_np, dense = _dense("two-tower-retrieval")
    x = torch.zeros((4, cfg.embed_dim), requires_grad=True)
    R._tower(dense["item"], x, cfg.dtype).sum().backward()
    jg = jax.grad(lambda z: JR._tower(dense_np["item"], z, jcfg.dtype).sum())(
        np.zeros((4, cfg.embed_dim), np.float32))
    assert torch.isfinite(x.grad).all()
    _close(x.grad, jg)


# ------------------------------------------------------------ the adapters
@pytest.mark.parametrize("arch", ARCHS)
def test_embed_from_workings_matches_the_direct_lookup(arch):
    """Each ``*_embed_from_workings`` over a working set that is the table
    itself (the inverse the ids) equals the direct ``*_embed_batch`` bit for
    bit and the reference's adapter; its gradient into the working rows
    (the bag's backward) equals the reference's vjp.  The takes are bags of
    one id (kernel 1 on the card): one bag call for DIN and DIEN, the
    history bag and the item's for two-tower."""
    cfg, jcfg = _smoke(arch)
    table = _tables(cfg.item_vocab, cfg.embed_dim, seed=3)
    batch = next(S.recsys_batches(cfg, batch=16, seed=2))
    tb = {k: _t(v) for k, v in batch.items()}
    spec = factory._recsys_wiring(cfg)
    engine = spec[1](cfg, TrainerConfig(), device="cpu")
    inv = engine.ids_from_batch(tb)["items"].to(torch.int32)
    direct = (R.two_tower_embed_batch if arch == "two-tower-retrieval"
              else R.din_embed_batch)({"items": _t(table)}, tb, cfg)
    wk = _t(table).requires_grad_(True)
    ops.reset_launches()
    got = spec[2](cfg)({"items": wk}, {"items": inv}, tb)
    assert ops.launches["embedding_bag_ref"] == (
        2 if arch == "two-tower-retrieval" else 1)
    jembed = (JR.two_tower_embed_from_workings if arch ==
              "two-tower-retrieval" else JR.din_embed_from_workings)(jcfg)
    want = jembed({"items": table}, {"items": inv.numpy()}, batch)
    assert got.keys() == direct.keys() == want.keys()
    rng = np.random.default_rng(0)
    cot = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
           for k, v in got.items()}
    for k in got:
        assert torch.equal(got[k], direct[k]), k
        _close(got[k], want[k], rtol=0, atol=1e-7)
    (g,) = torch.autograd.grad([got[k] for k in sorted(got)], wk,
                               [_t(cot[k]) for k in sorted(got)])
    _, vjp = jax.vjp(lambda w: jembed({"items": w}, {"items": inv.numpy()},
                                      batch), jnp.asarray(table))
    (jg,) = vjp({k: jnp.asarray(v) for k, v in cot.items()})
    assert ops.launches["embedding_bag_backward_ref"] == (
        2 if arch == "two-tower-retrieval" else 1)
    _close(g, jg, rtol=0, atol=1e-6)


# -------------------------------------------------------------- the trainer
def _tcfgs(merge="two_phase", placement="gather", cache_rows=None,
           capacity=None, n_pod=2, k=2):
    """The reference's factory-test settings in both packages: dense lr
    1e-3 with b1 0, sparse lr 0.1, accumulator 0.01."""
    jt = JTrainerConfig(
        n_pod=n_pod, kstep=JKStepConfig(lr=1e-3, k=k, b1=0.0, merge=merge),
        sparse=JSparseConfig(lr=0.1, initial_accumulator=0.01),
        placement="gather", capacity=capacity, log_every=1)
    t = TrainerConfig(
        n_pod=n_pod, kstep=KStepConfig(lr=1e-3, k=k, b1=0.0, merge=merge),
        sparse=SparseAdagradConfig(lr=0.1, initial_accumulator=0.01),
        placement=placement, cache_rows=cache_rows, capacity=capacity,
        log_every=1)
    return jt, t


def _pair(arch, merge="two_phase", placement="gather"):
    """The reference trainer (gather) and the port's on ``placement``, on
    the CPU, from the reference's state.  The cached placement runs a cache
    of the capacity's 512 rows over the 500-row smoke table."""
    cfg, jcfg = _smoke(arch)
    jt, t = _tcfgs(merge, placement,
                   cache_rows=512 if placement == "cached" else None)
    jtr = jbuild_trainer(arch, jt, model_cfg=jcfg, seed=3)
    state = from_reference(
        jax.device_get(jtr.dense), jax.device_get(jtr.tables),
        jax.device_get(jtr.sparse_state.accum),
        jax.device_get(jtr.opt_state), device="cpu")
    _, build_engine, embed_of, loss_of = factory._recsys_wiring(cfg)
    tr = HybridTrainer(None, build_engine(cfg, t, device="cpu"),
                       embed_of(cfg), loss_of(cfg), t, state=state,
                       device="cpu")
    return jtr, tr


def _logical(tr):
    tables, accum, _ = tr.engine.flush(tr.tables, tr.sparse_state.accum,
                                       tr.backend_state)
    return ({n: np.asarray(v) for n, v in tr.engine.export(tables).items()},
            {n: np.asarray(v) for n, v in accum.items()})


def _assert_tree_close(got, want, **tol):
    got, want = leaves(got), jax.tree.leaves(jax.device_get(want))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=str(i),
                                   **tol)


@pytest.mark.parametrize("arch,merge,placement", [
    ("din", "flat", "gather"), ("din", "two_phase", "gather"),
    ("din", "bf16", "gather"), ("din", "int8_ef", "gather"),
    ("din", "two_phase", "cached"),
    ("dien", "two_phase", "gather"), ("dien", "two_phase", "cached"),
    ("two-tower-retrieval", "two_phase", "gather"),
    ("two-tower-retrieval", "two_phase", "cached"),
])
def test_training_matches_the_reference(arch, merge, placement):
    """Smoke size, n_pod 2, k 2: 6 online steps (predict, then train;
    two-tower's stream has no labels, so it only trains) through the merges
    at steps 2, 4 and 6, from one state."""
    steps = 6
    cfg, _ = _smoke(arch)
    jtr, tr = _pair(arch, merge, placement)
    before = _logical(tr)[0]["items"].copy()
    batches = [b for _, b in zip(range(steps), S.recsys_batches(
        cfg, batch=32, seed=5))]
    jh, jauc = jfit_online(jtr, iter(batches), steps, window=5)
    ops.reset_launches()
    h, auc = fit_online(tr, iter(batches), steps, window=5)
    assert [r["step"] for r in h] == [r["step"] for r in jh] == list(
        range(1, steps + 1))
    np.testing.assert_allclose([r["loss"] for r in h],
                               [r["loss"] for r in jh], **LOSS_TOL)
    if arch == "two-tower-retrieval":
        assert auc is None and jauc is None
    else:
        np.testing.assert_allclose(auc, jauc, **LOSS_TOL)
    assert tr.overflow_dropped == jtr.overflow_dropped == 0
    tol = (TWO_TOWER_STATE_TOL if arch == "two-tower-retrieval"
           else STATE_TOL)
    tables, accum = _logical(tr)
    np.testing.assert_allclose(tables["items"], np.asarray(
        jax.device_get(jtr.tables)["items"]), **tol)
    np.testing.assert_allclose(accum["items"], np.asarray(
        jax.device_get(jtr.sparse_state.accum)["items"]), **tol)
    _assert_tree_close(tr.dense, jtr.dense, **tol)
    for f in ("m", "v_local", "v_hat"):
        _assert_tree_close(getattr(tr.opt_state, f),
                           getattr(jtr.opt_state, f), **tol)
    if merge == "int8_ef":
        _assert_tree_close(tr.opt_state.ef, jtr.opt_state.ef, rtol=1e-4,
                           atol=1e-5)
    assert not np.array_equal(tables["items"], before)      # trained
    # the CPU ran the plain versions: a bag call (two for two-tower) a pod
    # a step and a predict, its backward a pod a step, one push a step
    bags = 2 if arch == "two-tower-retrieval" else 1
    predicts = 0 if arch == "two-tower-retrieval" else 1
    push = ("sparse_adagrad_apply_ref" if placement == "gather"
            else "sparse_adagrad_cached_apply_ref")
    assert ops.launches["embedding_bag_ref"] == steps * (2 + predicts) * bags
    assert ops.launches["embedding_bag_backward_ref"] == steps * 2 * bags
    assert ops.launches[push] == steps
    assert ops.launches["fused_adam_ref"] == steps // 2      # local steps
    assert not any(v for k, v in ops.launches.items()
                   if not k.endswith("_ref"))


@pytest.mark.parametrize("arch", ARCHS)
def test_undersized_capacity_stays_finite(arch):
    """Capacity 32 under batches of 64: ids drop into the zero drop row,
    are counted, and nothing turns non-finite (two-tower's towers read the
    drop row through their guarded norm)."""
    _, t = _tcfgs(capacity=32, n_pod=1, k=1)
    cfg, _ = _smoke(arch)
    tr = build_trainer(arch, t, device="cpu")
    stream = S.recsys_batches(cfg, batch=64, seed=3)
    batch = next(stream)
    wss, *_ = tr.engine.pull_batch(tr.tables, tr.sparse_state.accum,
                                   tr.backend_state, tr._stage(batch))
    ws = wss["items"]
    dropped = ws.inverse == ws.rows.shape[0] - 1
    assert dropped.any() and not ws.rows[-1].any()    # the zero drop row
    hist = tr.fit(stream, 4)
    assert tr.overflow_dropped > 0
    assert all(np.isfinite(r["loss"]) for r in hist)
    for x in (list(tr.tables.values()) + list(tr.sparse_state.accum.values())
              + leaves(tr.dense)):
        assert torch.isfinite(x).all()
    assert np.isfinite(tr.predict(batch)).all()


# ----------------------------------------------------------------- serving
def _served_scores(srv, batch, requests_from_batch):
    """Each request's score from ``srv`` after one drain."""
    reqs = requests_from_batch(batch)
    for r in reqs:
        srv.submit(r)
    assert srv.drain() == len(reqs)
    return np.asarray([r.score for r in reqs])


@pytest.mark.parametrize("arch", ARCHS)
def test_ctr_server_scores_equal_predict_and_the_reference(arch):
    """A ``CTRServer`` (max_batch 16) over 40 requests, a padded tail
    included: its scores equal ``predict`` on the same instances and the
    reference server's from one state; DIN and DIEN score in (0, 1),
    two-tower's u·v in [-1, 1]."""
    cfg, _ = _smoke(arch)
    jtr, tr = _pair(arch)
    batch = next(S.recsys_batches(cfg, batch=40, seed=6))
    reqs = requests_from_batch(batch)
    assert len(reqs) == 40 and "label" not in reqs[0].features
    assert all(v.ndim == (1 if k in ("hist_ids", "hist_mask", "user_ids",
                                     "user_mask") else 0)
               for k, v in reqs[0].features.items())
    srv = build_ctr_server(tr, max_batch=16)
    served = _served_scores(srv, batch, requests_from_batch)
    assert srv.summary()["served"] == 40 and srv.stats["steps"] == 3
    direct = tr.predict({k: v for k, v in batch.items() if k != "label"})
    np.testing.assert_allclose(served, direct, rtol=1e-6, atol=1e-7)
    want = _served_scores(jbuild_server(jtr, max_batch=16), batch,
                          jrequests_from_batch)
    np.testing.assert_allclose(served, want, **TOL)
    if arch == "two-tower-retrieval":
        assert np.abs(served).max() <= 1 + 1e-6
    else:
        assert ((served > 0) & (served < 1)).all()


@pytest.mark.parametrize("n,levels", [(20000, None), (5000, 1000),
                                      (3000, 7), (9, 2), (1, None)])
def test_auc_equals_the_reference(n, levels):
    """The online AUC (ties at their average rank, by whole arrays) equals
    the reference's loop bit for bit, with and without ties."""
    rng = np.random.default_rng(n)
    scores = (rng.random(n) if levels is None
              else rng.integers(0, levels, n).astype(np.float32))
    labels = (rng.random(n) < 0.4).astype(np.float32)
    labels[0] = 1.0
    assert auc(labels, scores) == jauc(labels, scores)


# ---------------------------------------------------------------- launcher
def _launch(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(list(argv))
    return out.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_on_the_cpu(arch):
    last = _launch("--arch", arch, "--steps", "4", "--batch", "32",
                   "--device", "cpu", "--k", "2")
    assert last.startswith("final loss ")
    assert np.isfinite(float(last.split()[2]))
    assert ("online AUC" in last) == (arch != "two-tower-retrieval")
    assert "overflow_dropped 0" in last
    last = _launch("--arch", arch, "--steps", "3", "--batch", "32",
                   "--device", "cpu", "--placement", "cached", "--serve",
                   "--serve-batch", "8", "--rows", "300")
    assert "served 24" in last and np.isfinite(float(last.split()[2]))


def test_launcher_rows_caps_the_item_table():
    for arch in ARCHS:
        args = launch.build_argparser().parse_args(
            ["--arch", arch, "--rows", "300"])
        assert launch.model_config(args).item_vocab == 300
        args.smoke = False
        assert launch.model_config(args).item_vocab == 300
        args.rows = 10 ** 9
        assert launch.model_config(args).item_vocab == configs.get(
            arch).model_cfg.item_vocab
        args.rows = 10
        with pytest.raises(ValueError, match="at least 64 rows"):
            launch.model_config(args)
