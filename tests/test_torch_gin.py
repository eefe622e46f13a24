"""The port's GIN (A10e) against the reference, on the CPU.

Both sides start from one state: the reference's ``init_params``, exported
as numpy and loaded into the port (``interop.lm_from_reference``, which loads any reference parameter tree); graphs
from the ported numpy generators, which are checked equal to the
reference's.  The reference's message passing is ``jnp.take`` then
``jax.ops.segment_sum``; the port's is the bag's plain version on the CPU
(``ops.embedding_bag_working``), which adds each node's messages in
ascending edge order.

Tolerances, each with its reason:
- forward: rtol 1e-5, atol 1e-6 x the largest magnitude (the layers' f32
  products in other orders; GIN's sums of unnormalised neighbours make
  activations of ~1e3, so an absolute bar alone means nothing);
- gradients against ``jax.grad``: rtol 1e-4, atol 1e-6 x the leaf's
  largest magnitude (sums of width 16-64 and the bag's vjp in other
  orders; an element near 0 is a difference of such sums);
- the dense-adjacency oracle: the same as the forward;
- ``DenseTrainer`` against the reference's: 6 steps, losses and state
  within rtol 1e-4, atol 1e-6 at lr 1e-4 (gradient noise carried through
  Adam's division by sqrt(v)); under the lossy payloads (bf16, int8_ef)
  the port restarts from the reference's state before every step and an
  element may land up to 1.5 grid steps away: under bf16 one element in
  a thousand, as in ``test_torch_lm_train.py``; under int8_ef any number,
  each with the residual off by the same amount (params + residual within
  the tolerance above: at this width a leaf of 16 biases near 0 has a
  grid of ~1e-5 and a rounding boundary within its float32 noise);
- the generators, the sampler and the plain bag past 256 columns: exact.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.kstep import KStepConfig as JKStepConfig
from repro.data import graph_sampler as JGS
from repro.data import synthetic as JS
from repro.models import gin as JG
from repro.runtime import trainer as jtrainer
from repro_torch import configs
from repro_torch.checkpoint.ckpt import map_with_names
from repro_torch.core import kstep as tk
from repro_torch.data import graph_sampler as GS
from repro_torch.data import synthetic as S
from repro_torch.interop import dense_trainer_from_reference, lm_from_reference
from repro_torch.kernels import ops
from repro_torch.models import gin as G
from repro_torch.runtime.factory import build_trainer
from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig

FWD = dict(rtol=1e-5, atol_scale=1e-6)
GRAD = dict(rtol=1e-4, atol_scale=1e-6)
TRAIN = dict(rtol=1e-4, atol=1e-6)


def _close(got, want, rtol, atol_scale):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_scale * max(float(np.abs(want).max(initial=0.0)), 1e-30))


def _cfgs(**kw):
    base = dict(n_layers=3, d_in=24, d_hidden=16, n_classes=4)
    base.update(kw)
    return JG.GINConfig(**base), G.GINConfig(**base)


def _params(jcfg, seed=0, eps=None):
    p = jax.device_get(JG.init_params(jax.random.key(seed), jcfg))
    if eps is not None:   # eps away from its init, so that it matters
        p["eps"] = np.asarray(eps, np.float32)
    return p


def _graph(seed=0, n=120, deg=5, d=24, classes=4):
    return S.community_graph(seed, n, deg, d, classes)


def _sorted_leaves(tree):
    """A port tree's leaves in the reference's (sorted-key) order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _tt(x):
    return torch.from_numpy(np.asarray(x))


def _torch_batch(b):
    return {k: _tt(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _molecules(seed=3, batch=6, d=24, classes=4):
    return next(S.molecule_batches(seed, batch, 9, 14, d, classes))


# ------------------------------------------------------------- generators
def test_generators_and_sampler_equal_the_reference():
    g, jg = S.community_graph(5, 400, 7, 11, 6), JS.community_graph(
        5, 400, 7, 11, 6)
    for f in ("x", "edge_src", "edge_dst", "labels"):
        a, b = getattr(g, f), getattr(jg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for worker in (0, 1):
        ours = S.molecule_batches(2, 5, 8, 12, 3, 2, worker=worker)
        theirs = JS.molecule_batches(2, 5, 8, 12, 3, 2, worker=worker)
        for _ in range(2):
            a, b = next(ours), next(theirs)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    src, dst = g.edge_src.astype(np.int64), g.edge_dst.astype(np.int64)
    sampler = GS.NeighborSampler(400, src, dst)
    jsampler = JGS.NeighborSampler(400, src, dst)
    rng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        seeds = rng.choice(400, 32, replace=False)
        assert np.array_equal(seeds, jrng.choice(400, 32, replace=False))
        a = sampler.sample_block(rng, seeds, (6, 4))
        b = jsampler.sample_block(jrng, seeds, (6, 4))
        assert a.keys() == b.keys()
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            assert np.array_equal(a[k], b[k])
    for fan in ((15, 10), (8, 5)):
        assert GS.NeighborSampler.worst_case_nodes(1024, fan) == \
            JGS.NeighborSampler.worst_case_nodes(1024, fan)
        assert GS.NeighborSampler.worst_case_edges(1024, fan) == \
            JGS.NeighborSampler.worst_case_edges(1024, fan)
    spec, jspec = configs.get("gin-tu"), jconfigs.get("gin-tu")
    assert spec.source == jspec.source == "arXiv:1810.00826; paper"
    for k in jspec.shapes:
        assert spec.shapes[k].dims == jspec.shapes[k].dims


# ---------------------------------------------------------------- forward
FORWARD_CASES = {
    "node": (dict(), "node"),
    "edge mask": (dict(), "mask"),
    "pre_project": (dict(pre_project=True), "node"),
    "pre_project, edge mask": (dict(pre_project=True), "mask"),
    "GIN-0": (dict(train_eps=False), "node"),
    "graph readout": (dict(readout="graph"), "graph"),
}


def _case_inputs(kind):
    """(batch as numpy, forward kwargs' keys) for a forward case."""
    if kind == "graph":
        b = _molecules()
        return b, dict(graph_ids=b["graph_ids"],
                       num_graphs=b["labels"].shape[0])
    g = _graph()
    b = {"x": g.x, "edge_src": g.edge_src, "edge_dst": g.edge_dst,
         "labels": g.labels}
    kw = {}
    if kind == "mask":
        rng = np.random.default_rng(1)
        b["edge_mask"] = (rng.random(g.edge_src.shape) < 0.7).astype(
            np.float32)
        b["node_mask"] = (rng.random(g.labels.shape) < 0.4).astype(
            np.float32)
        kw["edge_mask"] = b["edge_mask"]
    return b, kw


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_matches_the_reference(case):
    knobs, kind = FORWARD_CASES[case]
    jcfg, tcfg = _cfgs(**knobs)
    pnp = _params(jcfg, eps=[0.3, -0.2, 0.7])
    b, kw = _case_inputs(kind)
    want = np.asarray(JG.forward(
        jax.tree.map(jnp.asarray, pnp), jnp.asarray(b["x"]),
        jnp.asarray(b["edge_src"]), jnp.asarray(b["edge_dst"]), jcfg,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}))
    ops.reset_launches()
    got = G.forward(lm_from_reference(pnp, "cpu"), _tt(b["x"]),
                    _tt(b["edge_src"]), _tt(b["edge_dst"]), tcfg,
                    **{k: _tt(v) if isinstance(v, np.ndarray) else v
                       for k, v in kw.items()}).numpy()
    assert got.shape == want.shape
    _close(got, want, **FWD)
    # one bag a layer, one more for the graph readout
    assert ops.launches["embedding_bag_ref"] == 3 + (kind == "graph")


def test_forward_matches_the_dense_adjacency_oracle():
    """The port's bag path against the port's dense-adjacency oracle (the
    reference's own test of its model)."""
    _, tcfg = _cfgs()
    p = lm_from_reference(_params(_cfgs()[0], eps=[0.1, 0.2, -0.3]), "cpu")
    g = _graph(seed=4)
    adj = torch.zeros((120, 120))
    adj.index_put_((_tt(g.edge_src).long(), _tt(g.edge_dst).long()),
                   torch.ones(g.edge_src.shape), accumulate=True)
    got = G.forward(p, _tt(g.x), _tt(g.edge_src), _tt(g.edge_dst), tcfg)
    want = G.dense_reference_forward(p, _tt(g.x), adj, tcfg)
    _close(got.numpy(), want.numpy(), **FWD)


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_gradients_match_jax_grad(case):
    knobs, kind = FORWARD_CASES[case]
    jcfg, tcfg = _cfgs(**knobs)
    pnp = _params(jcfg, seed=2, eps=[0.3, -0.2, 0.7])
    b, _ = _case_inputs(kind)
    jloss, jgrads = jax.value_and_grad(JG.loss_fn)(
        jax.tree.map(jnp.asarray, pnp), _jax_batch(b), jcfg)
    p = lm_from_reference(pnp, "cpu")
    leaves = _sorted_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = G.loss_fn(p, _torch_batch(b), tcfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for got, want in zip(grads, jax.tree.leaves(jgrads)):
        want = np.asarray(want)
        if got is None:      # GIN-0's eps: no gradient at all
            assert not np.any(want)
            continue
        _close(got.numpy(), want, **GRAD)


# --------------------------------------------------------------- trainer
SCHEDULES = [("flat", 0), ("two_phase", 0), ("bf16", 0), ("int8_ef", 0),
             ("two_phase", 1)]
LOSSY = ("bf16", "int8_ef")


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_like(jtr, loss_fn, cfg):
    ttr = dense_trainer_from_reference(
        jax.device_get(jtr.params), jax.device_get(jtr.opt_state), loss_fn,
        cfg, device="cpu")
    for snap, merged in jtr._pending_merges:
        ttr._pending_merges.append(tuple(
            lm_from_reference(jax.device_get(t), "cpu")
            for t in (snap, merged)))
    return ttr


def _assert_state_close(ttr, jtr, merge):
    js, ts = jtr.opt_state, ttr.opt_state
    assert int(ts.step) == int(js.step) == ttr.step_num == jtr.step_num
    pairs = [(ttr.params, jtr.params, True), (ts.m, js.m, False),
             (ts.v_local, js.v_local, False), (ts.v_hat, js.v_hat, False)]
    if merge == "int8_ef":
        pairs.append((ts.ef, js.ef, True))
    off_grid = total = 0
    params = _leaves_np(jtr.params)
    for got, want, gridded in pairs:
        for a, b, p in zip([x.numpy() for x in _sorted_leaves(got)],
                           _leaves_np(want), params):
            if merge in LOSSY and gridded:
                step = (np.full(b.shape, 2 * np.abs(p).max() / 127.0)
                        if merge == "int8_ef" else np.abs(b) * 2.0 ** -7)
                off = np.abs(a - b) > TRAIN["atol"] + TRAIN["rtol"] * np.abs(b)
                assert np.all(np.abs(a - b)[off] <= 1.5 * step[off])
                off_grid += int(off.sum())
                total += off.size
            else:
                np.testing.assert_allclose(a, b, **TRAIN)
    if merge == "int8_ef":
        # an element that rounds to the neighbouring grid point on one
        # side leaves the residual short by the same amount, so params +
        # residual (the unrounded merge) agree to float32 noise everywhere
        for a, b, ea, eb in zip(_sorted_leaves(ttr.params),
                                _leaves_np(jtr.params),
                                _sorted_leaves(ts.ef), _leaves_np(js.ef)):
            np.testing.assert_allclose((a + ea).numpy(), b + eb, **TRAIN)
    else:
        assert off_grid <= total // 1000


def _podded_graph(n_pod=2):
    g = _graph(seed=6)
    return {k: np.stack([v] * n_pod) for k, v in
            [("x", g.x), ("edge_src", g.edge_src), ("edge_dst", g.edge_dst),
             ("labels", g.labels)]}


@pytest.mark.parametrize("merge,delay", SCHEDULES)
def test_dense_trainer_matches_the_reference(merge, delay):
    """n_pod 2, k 2, 6 steps over the full graph (each pod the whole
    graph, as the launcher trains it) from the reference's state after one
    step: losses, podded parameters and m, v_local, v_hat (and the int8
    residual)."""
    jcfg, tcfg = _cfgs()
    kw = dict(lr=1e-4, k=2, merge=merge, b1=0.9)
    jtr = jtrainer.DenseTrainer(
        lambda p, b: JG.loss_fn(p, b, jcfg),
        jax.tree.map(jnp.asarray, _params(jcfg, seed=5)),
        jtrainer.TrainerConfig(n_pod=2, kstep=JKStepConfig(**kw),
                               merge_delay=delay))
    cfg = TrainerConfig(n_pod=2, kstep=tk.KStepConfig(**kw),
                        merge_delay=delay)
    loss_fn = lambda p, b: G.loss_fn(p, b, tcfg)   # noqa: E731
    batch = _podded_graph()
    jtr.train_step(batch, podded=True)   # pods apart after one step
    ttr = _port_like(jtr, loss_fn, cfg)
    for _ in range(6):
        if merge in LOSSY:
            ttr = _port_like(jtr, loss_fn, cfg)
        want = float(jtr.train_step(batch, podded=True))
        got = ttr.train_step(batch, podded=True)
        np.testing.assert_allclose(float(got), want, **TRAIN)
        if merge in LOSSY:
            _assert_state_close(ttr, jtr, merge)
    _assert_state_close(ttr, jtr, merge)


def test_factory_builds_a_dense_trainer_over_gin():
    cfg = dataclasses.replace(configs.get("gin-tu").smoke_cfg, d_in=24,
                              n_classes=4)
    tr = build_trainer("gin-tu", TrainerConfig(n_pod=2), model_cfg=cfg,
                       device="cpu")
    assert isinstance(tr, DenseTrainer)
    assert tr.params["layers"][0]["w1"].shape == (2, 24, cfg.d_hidden)
    ops.reset_launches()
    loss = tr.train_step(_podded_graph(), podded=True)
    assert np.isfinite(float(loss))
    # per pod: one bag a layer; backward one a layer but the first (x needs
    # no gradient)
    assert ops.launches["embedding_bag_ref"] == 2 * cfg.n_layers
    assert ops.launches["embedding_bag_backward_ref"] == 2 * (
        cfg.n_layers - 1)
    assert ops.launches["fused_adam_ref"] == 0    # k 1: every step merges


# -------------------------------------------------- the bag past 256 columns
@pytest.mark.parametrize("D", [257, 602, 1433])
def test_plain_bag_past_256_columns(D):
    """The bag's plain version (the CPU path, and what the card's kernels
    are held to) at GIN's input widths: forward and working-row gradient
    equal to the reference's take + segment_sum and its vjp."""
    rng = np.random.default_rng(D)
    working = rng.standard_normal((50, D)).astype(np.float32)
    inv = rng.integers(0, 50, 400).astype(np.int32)
    seg = rng.integers(-2, 62, 400).astype(np.int32)
    w = (rng.random(400) < 0.8).astype(np.float32)
    g = rng.standard_normal((60, D)).astype(np.float32)

    def jbag(x):
        msg = jnp.take(x, inv, axis=0) * w[:, None]
        return jax.ops.segment_sum(msg, seg, num_segments=60)

    want, vjp = jax.vjp(jbag, jnp.asarray(working))
    x = _tt(working).requires_grad_(True)
    out = ops.embedding_bag_working(x, _tt(inv), _tt(seg), _tt(w), 60)
    (gx,) = torch.autograd.grad(out, x, _tt(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(vjp(g)[0]))


# ----------------------------------------------------------------- knobs
@pytest.mark.parametrize("field,value", [("dtype", torch.bfloat16),
                                         ("message_dtype", torch.bfloat16)])
def test_bf16_dtypes_raise_naming_the_roadmap_item(field, value):
    cfg = dataclasses.replace(_cfgs()[1], **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        G.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    p = G.init_params(torch.Generator().manual_seed(0), _cfgs()[1],
                      device="cpu")
    g = _graph()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        G.forward(p, _tt(g.x), _tt(g.edge_src), _tt(g.edge_dst), cfg)


# --------------------------------------------------------------- example
def _accuracy(params, g, cfg):
    with torch.no_grad():
        logits = G.forward(tk.pod_slice(params, 0), _tt(g.x),
                           _tt(g.edge_src), _tt(g.edge_dst), cfg)
    return float(np.mean(np.argmax(logits.numpy(), -1) == g.labels))


FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "gin_example_init.npz"


def _example_init(cfg):
    """The reference example's initial weights (``jax.random.key(0)``),
    from the fixture ``tools/gin_example_init.py`` writes."""
    like = G.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with np.load(FIXTURE) as data:
        return map_with_names(lambda n, _: torch.from_numpy(data[n]), like)


def test_example_init_fixture_is_the_reference_draw():
    """The fixture holds what the reference example draws, leaf for leaf."""
    cfg = dataclasses.replace(jconfigs.get("gin-tu").smoke_cfg, d_in=32,
                              n_classes=5)
    want = jax.device_get(JG.init_params(jax.random.key(0), cfg))
    got = _example_init(dataclasses.replace(
        configs.get("gin-tu").smoke_cfg, d_in=32, n_classes=5))
    for a, b in zip(_sorted_leaves(got), _leaves_np(want)):
        assert np.array_equal(a.numpy(), b)


def test_reference_example_accuracy_bars():
    """``examples/train_gin.py``'s two regimes through the port, from the
    example's initial weights: full-graph accuracy above 0.5 after 60
    steps and minibatch (fanouts 8, 5 through the ported sampler) above
    0.4 after 80, the example's bars."""
    cfg = dataclasses.replace(configs.get("gin-tu").smoke_cfg, d_in=32,
                              n_classes=5)
    loss_fn = lambda p, b: G.loss_fn(p, b, cfg)    # noqa: E731
    g = S.community_graph(seed=0, n_nodes=2000, avg_degree=8, d_feat=32,
                          n_classes=5)
    tr = DenseTrainer(loss_fn, _example_init(cfg),
        TrainerConfig(n_pod=2, kstep=tk.KStepConfig(lr=3e-3, k=5, b1=0.9)),
        device="cpu")
    batch = {k: np.stack([v] * 2) for k, v in
             [("x", g.x), ("edge_src", g.edge_src), ("edge_dst", g.edge_dst),
              ("labels", g.labels)]}
    for _ in range(60):
        tr.train_step(batch, podded=True)
    assert _accuracy(tr.params, g, cfg) > 0.5

    g = S.community_graph(seed=1, n_nodes=5000, avg_degree=10, d_feat=32,
                          n_classes=5)
    sampler = GS.NeighborSampler(5000, g.edge_src.astype(np.int64),
                                 g.edge_dst.astype(np.int64))
    rng = np.random.default_rng(0)
    tr = DenseTrainer(loss_fn, _example_init(cfg),
        TrainerConfig(n_pod=1, kstep=tk.KStepConfig(lr=3e-3, k=1, b1=0.9)),
        device="cpu")
    for _ in range(80):
        seeds = rng.choice(5000, 128, replace=False)
        blk = sampler.sample_block(rng, seeds, fanouts=(8, 5))
        tr.train_step({
            "x": g.x[blk["nodes"]], "edge_src": blk["edge_src"],
            "edge_dst": blk["edge_dst"], "edge_mask": blk["edge_mask"],
            "labels": g.labels[blk["nodes"]], "node_mask": blk["seed_mask"]})
    assert _accuracy(tr.params, g, cfg) > 0.4
