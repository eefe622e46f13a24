"""The port's DLRM training slice against the reference, on the CPU.

``build_trainer("dlrm-mlperf", ...)`` -> ``fit_online`` /
``HybridTrainer.train_step``: the pull of 26 single-hot tables, per pod
the 26 takes (bags of one id), the bottom MLP, the dot interaction and its
backward (on the CPU the plain version, autograd's vjp of it), the top MLP
and the BCE loss, k-step Adam on the dense towers and one AdaGrad push a
table.

Both sides start from one state (the reference trainer's, exported as
numpy and loaded through ``repro_torch.interop.from_reference``) and take
the same ``dlrm_batches`` stream.  Tolerances, and why:
  - the interaction's gradient: the forward's (``tests/test_kernels.py``'s
    TOL, as ``tests/test_torch_dlrm.py`` holds the forward): atol 1e-5 * D,
    rtol 4e-5 in float32; atol 2e-2 * D, rtol 8e-2 in bfloat16 (sums in
    other orders; bfloat16 also rounds at other places);
  - training at smoke size: the reference's own factory parity
    (``tests/test_smoke_archs.py::test_recsys_factory_fit_parity_with_
    handrolled``): losses rtol 1e-5, atol 1e-6; tables and accumulators
    rtol 1e-4, atol 1e-5; dense atol 1e-6 (the matmuls sum in other
    orders);
  - the cached full mirror against gather: bit-equal (the reference's
    placement contract, held against gather).
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
from repro.models import recsys as JR
from repro.runtime.factory import build_trainer as jbuild_trainer
from repro.runtime.online import fit_online as jfit_online
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.core.kstep import KStepConfig, leaves
from repro_torch.core.sparse_optim import SparseAdagradConfig
from repro_torch.data import synthetic as S
from repro_torch.interop import from_reference
from repro_torch.kernels import dot_interaction as tdot
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as launch
from repro_torch.models import recsys as R
from repro_torch.runtime.factory import build_dlrm_engine, build_trainer
from repro_torch.runtime.online import fit_online
from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

torch.set_num_threads(1)

SMOKE = configs.get("dlrm-mlperf").smoke_cfg
JSMOKE = jconfigs.get("dlrm-mlperf").smoke_cfg
KTOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py's TOL
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)
DENSE_TOL = dict(rtol=0, atol=1e-6)
ROW_CAP = 1000                               # rows per table, full width
# a cache covering every smoke table (200 rows) and the pull capacity (256):
# the full mirror
MIRROR = 256


def _capped(model_cfg, cap):
    return dataclasses.replace(
        model_cfg, rows=tuple(min(r, cap) for r in model_cfg.rows))


# ------------------------------------------------- the interaction's gradient
def _grad_case(B, F, D, dtype, seed):
    """feats and an upstream gradient from one numpy draw, as both packages
    take them (bfloat16: the float32 values rounded once, by JAX)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F, D))
    g = rng.standard_normal((B, F * (F - 1) // 2))
    jx, jg = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, g))
    tx, tg = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jx, jg))
    return jx, jg, tx, tg


@pytest.mark.parametrize("B,F,D,dtype", [
    (64, 27, 128, "float32"), (16, 27, 128, "bfloat16"),
    (12, 5, 7, "float32"), (9, 13, 33, "bfloat16"), (8, 2, 16, "float32"),
    (8, 1, 16, "float32"), (5, 27, 3, "float32"),
])
def test_interaction_gradient_matches_the_reference_vjp(B, F, D, dtype):
    jx, jg, tx, tg = _grad_case(B, F, D, dtype, seed=B + F + D)
    x = tx.clone().requires_grad_(True)
    ops.reset_launches()
    (got,) = torch.autograd.grad(ops.dot_interaction(x), x, tg)
    assert ops.launches["dot_interaction_ref"] == 1
    assert ops.launches["dot_interaction_backward_ref"] == 1
    assert ops.launches["dot_interaction_backward"] == 0
    assert got.dtype == tx.dtype and got.shape == (B, F, D)
    plain = tref.dot_interaction_backward_ref(tg, tx)
    assert plain.dtype == tx.dtype and plain.shape == (B, F, D)
    _, vjp = jax.vjp(JR.dot_interaction, jx)
    want = np.asarray(vjp(jg)[0].astype(jnp.float32))
    tol = dict(atol=KTOL[dtype] * D, rtol=KTOL[dtype] * 4)
    for x_ in (got, plain):
        np.testing.assert_allclose(x_.to(torch.float32).numpy(), want, **tol)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               plain.to(torch.float32).numpy(), **tol)
    if F == 1:
        assert not got.any() and not plain.any()
    # as in DLRM's tower, the gradient arrives as a column slice of the top
    # MLP's input's (``torch.cat([x, inter])``): a strided view
    x = tx.clone().requires_grad_(True)
    top_in = torch.cat([torch.zeros(B, 3, dtype=tx.dtype),
                        ops.dot_interaction(x)], dim=1)
    wide = torch.cat([torch.ones(B, 3, dtype=tg.dtype), tg], dim=1)
    (strided,) = torch.autograd.grad(top_in, x, wide)
    assert torch.equal(strided, got)
    assert torch.equal(tref.dot_interaction_backward_ref(wide[:, 3:], tx),
                       plain)
    with pytest.raises(ValueError, match="CUDA"):
        tdot.dot_interaction_backward_cuda(tg, tx)


# ----------------------------------------------------------- training, smoke
def _tcfgs(placement="gather", cache_rows=None, capacity=None, n_pod=2,
           k=2):
    """The reference's factory-test settings (``_recsys_tcfg``) in both
    packages: dense lr 1e-3 with b1 0, sparse lr 0.1, accumulator 0.01."""
    jt = JTrainerConfig(
        n_pod=n_pod, kstep=JKStepConfig(lr=1e-3, k=k, b1=0.0),
        sparse=JSparseConfig(lr=0.1, initial_accumulator=0.01),
        placement="gather", capacity=capacity, log_every=1)
    t = TrainerConfig(
        n_pod=n_pod, kstep=KStepConfig(lr=1e-3, k=k, b1=0.0),
        sparse=SparseAdagradConfig(lr=0.1, initial_accumulator=0.01),
        placement=placement, cache_rows=cache_rows, capacity=capacity,
        log_every=1)
    return jt, t


def _pair(placement="gather", cache_rows=None, model=SMOKE, jmodel=JSMOKE,
          **kw):
    """The reference trainer (gather) and the port's on ``placement``, on
    the CPU, from the reference's state."""
    jt, t = _tcfgs(placement, cache_rows, **kw)
    jtr = jbuild_trainer("dlrm-mlperf", jt, model_cfg=jmodel, seed=3)
    state = from_reference(
        jax.device_get(jtr.dense), jax.device_get(jtr.tables),
        jax.device_get(jtr.sparse_state.accum),
        jax.device_get(jtr.opt_state), device="cpu")
    tr = HybridTrainer(None, build_dlrm_engine(model, t, device="cpu"),
                       R.dlrm_embed_from_workings(model),
                       R.dlrm_hybrid_loss(model), t, state=state,
                       device="cpu")
    return jtr, tr


def _logical(tr):
    """(tables, accum) in logical row layout (the cached placement's
    flushed to its host tables), as numpy."""
    tables, accum, _ = tr.engine.flush(tr.tables, tr.sparse_state.accum,
                                       tr.backend_state)
    return ({n: np.asarray(v) for n, v in tr.engine.export(tables).items()},
            {n: np.asarray(v) for n, v in accum.items()})


def _assert_close(got, want, **tol):
    assert got.keys() == want.keys()
    for n in got:
        np.testing.assert_allclose(got[n], np.asarray(want[n]), err_msg=n,
                                   **tol)


@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_training_matches_the_reference(placement):
    """Smoke size, n_pod 2, k 2: 6 online steps (predict, then train)
    through the merges at steps 2, 4 and 6, from one state."""
    steps = 6
    jtr, tr = _pair(placement, cache_rows=MIRROR if placement == "cached"
                    else None)
    before = _logical(tr)[0]["emb_00"].copy()
    batches = list(zip(range(steps), S.dlrm_batches(
        seed=5, batch=64, rows=SMOKE.rows)))
    jh, jauc = jfit_online(jtr, iter([b for _, b in batches]), steps,
                           window=5)
    ops.reset_launches()
    h, auc = fit_online(tr, iter([b for _, b in batches]), steps, window=5)
    assert [r["step"] for r in h] == [r["step"] for r in jh] == list(
        range(1, steps + 1))
    np.testing.assert_allclose([r["loss"] for r in h],
                               [r["loss"] for r in jh], **LOSS_TOL)
    np.testing.assert_allclose(auc, jauc, **LOSS_TOL)
    assert tr.overflow_dropped == jtr.overflow_dropped == 0
    tables, accum = _logical(tr)
    _assert_close(tables, jax.device_get(jtr.tables), **TABLE_TOL)
    _assert_close(accum, jax.device_get(jtr.sparse_state.accum), **TABLE_TOL)
    for a, b in zip(leaves(tr.dense), jax.tree.leaves(jtr.dense)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **DENSE_TOL)
    assert not np.array_equal(tables["emb_00"], before)   # trained
    # the CPU ran the plain versions: the interaction and the 26 takes (bags
    # of one id) once a pod a step and once a predict, their backwards once
    # a pod a step, one push a table
    push = ("sparse_adagrad_apply_ref" if placement == "gather"
            else "sparse_adagrad_cached_apply_ref")
    assert ops.launches["dot_interaction_ref"] == steps * (2 + 1)
    assert ops.launches["dot_interaction_backward_ref"] == steps * 2
    assert ops.launches["embedding_bag_ref"] == steps * (2 + 1) * 26
    assert ops.launches["embedding_bag_backward_ref"] == steps * 2 * 26
    assert ops.launches[push] == steps * SMOKE.n_sparse
    assert ops.launches["fused_adam_ref"] == steps // 2     # local steps
    assert not any(v for k, v in ops.launches.items()
                   if not k.endswith("_ref"))


def test_cached_full_mirror_is_gather_bit_for_bit():
    """``cache_rows`` covering every table: the cache is a full mirror, and
    the cached placement trains as gather does, bit for bit (the
    reference's ``test_recsys_factory_placement_parity``, held against
    gather)."""
    _, t = _tcfgs()
    stream = S.dlrm_batches(seed=3, batch=64, rows=SMOKE.rows)
    batches = [next(stream) for _ in range(6)]
    runs = []
    for placement, cache_rows in (("gather", None), ("cached", MIRROR)):
        tr = build_trainer("dlrm-mlperf", dataclasses.replace(
            t, placement=placement, cache_rows=cache_rows), seed=0,
            device="cpu")
        hist = tr.fit(iter(batches), 6)
        runs.append(([r["loss"] for r in hist], *_logical(tr),
                     [x.clone() for x in leaves(tr.dense)], tr))
    (lg, tg, ag, dg, g), (lc, tc, ac, dc, c) = runs
    assert lg == lc and len(lg) == 6
    for n in tg:
        np.testing.assert_array_equal(tg[n], tc[n], err_msg=n)
        np.testing.assert_array_equal(ag[n], ac[n], err_msg=n)
    assert all(torch.equal(x, y) for x, y in zip(dg, dc))
    assert c.sparse_metrics()["evictions_total"] == 0
    assert g.overflow_dropped == c.overflow_dropped == 0


def test_undersized_capacity_drops_ids_and_stays_finite():
    """Capacity 32 under batches of 128: ids drop to the zero drop row,
    are counted, and nothing turns non-finite (the reference's
    ``test_recsys_undersized_capacity_degrades_gracefully``)."""
    _, t = _tcfgs(capacity=32, n_pod=1, k=1)
    tr = build_trainer("dlrm-mlperf", t, device="cpu")
    hist = tr.fit(S.dlrm_batches(seed=3, batch=128, rows=SMOKE.rows), 4)
    assert tr.overflow_dropped > 0
    assert all(np.isfinite(r["loss"]) for r in hist)
    for x in (list(tr.tables.values()) + list(tr.sparse_state.accum.values())
              + leaves(tr.dense)):
        assert torch.isfinite(x).all()


# ------------------------------------------------------ the published widths
def test_published_widths_train_as_the_reference():
    """Embed 128, bottom 13-512-256-128, top 479-1024-1024-512-256-1, each
    table capped at 1000 rows; 2 steps of 256 from one state.  Losses within
    LOSS_TOL, tables and accumulators within TABLE_TOL; dense within atol
    1e-4, a tenth of the learning rate: the 479 x 1024 products sum in
    other orders, and Adam divides each gradient by its root mean square,
    so a weight whose gradient is a few ulps from zero moves by a
    different fraction of lr in each framework (1.2e-5 here)."""
    model = _capped(configs.get("dlrm-mlperf").model_cfg, ROW_CAP)
    jmodel = _capped(jconfigs.get("dlrm-mlperf").model_cfg, ROW_CAP)
    jtr, tr = _pair(model=model, jmodel=jmodel, capacity=256, k=20)
    assert tr.dense["top"][0]["w"].shape == (2, 479, 1024)
    stream = S.dlrm_batches(seed=6, batch=256, rows=model.rows)
    for _ in range(2):
        b = next(stream)
        np.testing.assert_allclose(float(tr.train_step(b)),
                                   float(jtr.train_step(b)), **LOSS_TOL)
    tables, accum = _logical(tr)
    _assert_close(tables, jax.device_get(jtr.tables), **TABLE_TOL)
    _assert_close(accum, jax.device_get(jtr.sparse_state.accum), **TABLE_TOL)
    for a, b in zip(leaves(tr.dense), jax.tree.leaves(jtr.dense)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


# ------------------------------------------------------------------ launcher
def _launch(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(list(argv))
    return out.getvalue().strip().splitlines()[-1]


def test_launcher_trains_dlrm_on_the_cpu():
    last = _launch("--arch", "dlrm-mlperf", "--steps", "4", "--batch", "64",
                   "--device", "cpu")
    assert last.startswith("final loss ")
    assert np.isfinite(float(last.split()[2]))
    assert "online AUC" in last and "overflow_dropped 0" in last
    last = _launch("--arch", "dlrm-mlperf", "--steps", "3", "--batch", "64",
                   "--device", "cpu", "--placement", "cached")
    assert "cache_hit_rate" in last and "overflow_dropped 0" in last


def test_launcher_rows_caps_each_dlrm_table():
    args = launch.build_argparser().parse_args(
        ["--arch", "dlrm-mlperf", "--rows", "50", "--steps", "2"])
    assert launch.model_config(args).rows == (50,) * 26
    args.smoke = False
    rows = launch.model_config(args).rows
    assert rows == tuple(min(r, 50) for r in R.CRITEO_ROWS) and min(rows) == 3
    args = launch.build_argparser().parse_args(
        ["--arch", "baidu-ctr", "--rows", "500"])
    assert launch.model_config(args).rows == 500
    last = _launch("--arch", "dlrm-mlperf", "--rows", "50", "--steps", "2",
                   "--device", "cpu")
    assert np.isfinite(float(last.split()[2]))
    assert "overflow_dropped 0" in last
