"""The port's training slice (pull -> bag forward/backward -> k-step Adam ->
AdaGrad push) against the reference, on the CPU.

The reference runs its Pallas kernels in interpret mode
(``REPRO_KERNEL_INTERPRET=1``, set by ``tests/conftest.py``) with
``fused_kernels=True``; the port runs the kernels' plain versions.  Inputs
are numpy, from fixed seeds; both sides start from one state exported from
the reference (``repro_torch.interop.from_reference``).

Tolerances, and why:
  - The push, across frameworks: the table within rtol = 1e-6 (atol 1e-9).
    XLA's fused ``adagrad_row_updates`` recomputes ``a + g*g`` inside its
    fusion, so its ``delta`` can differ from PyTorch's by up to 2 ulps; the
    squared gradient ``g2``, and so the accumulator, are bit-equal.
  - Within the port, the kernel's pad rule (skip ``i > 0`` with
    ``uids[i] <= uids[i-1]``) gives the plain ``index_add_`` result bit for
    bit on the reference's own ``pull_working_set`` layouts.
  - The whole slice, 6 steps at n_pod 2, k 2: rtol = 1e-4, atol = 1e-6 on
    losses, AUC, dense parameters, tables, accumulator and optimizer state.
    Every step adds a few f32 ulps of difference (the matmuls, softmax and
    reductions sum in other orders, XLA contracts multiply-adds), and
    Adam's ``m / sqrt(v)`` amplifies relative differences of small
    gradients; overflow counts and step counts are equal.
"""

import contextlib
import io
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import embedding_backend as jbe
from repro.core.kstep import KStepConfig as JKStepConfig
from repro.core.sparse_optim import SparseAdagrad as JSparseAdagrad
from repro.core.sparse_optim import SparseAdagradConfig as JSparseConfig
from repro.data import synthetic as JS
from repro.runtime.factory import build_trainer as jbuild_trainer
from repro.runtime.online import fit_online as jfit_online
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.core import embedding_backend as tbe
from repro_torch.core.kstep import KStepConfig
from repro_torch.core.sparse_optim import (
    SparseAdagrad,
    SparseAdagradConfig,
    SparseAdagradState,
)
from repro_torch.data import synthetic as S
from repro_torch.interop import from_reference
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.sparse_adagrad import adagrad_row_updates
from repro_torch.launch import train as launch
from repro_torch.models import common, recsys as R
from repro_torch.runtime.factory import build_ctr_engine, build_ctr_server
from repro_torch.runtime.factory import build_trainer
from repro_torch.runtime.online import fit_online
from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

torch.set_num_threads(1)

SMOKE = configs.get("baidu-ctr").smoke_cfg
JSMOKE = jconfigs.get("baidu-ctr").smoke_cfg
SLICE = dict(rtol=1e-4, atol=1e-6)
LR, EPS = 0.5, 1e-10


# ------------------------------------------------------------------ the push
def _push_case(seed, rows, dim, n_ids, capacity):
    """A table and accumulator, one batch's ids deduplicated by the
    REFERENCE's ``_dedup``, and row grads whose pad positions are zero (no
    id slot maps to a pad) and whose drop row is not."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    accum = (rng.random((rows, dim)) + 0.01).astype(np.float32)
    ids = rng.integers(0, rows, n_ids).astype(np.int32)
    uids, inv, _ = jbe._dedup(jnp.asarray(ids), capacity)
    uids = np.array(uids)
    grads = rng.standard_normal((capacity + 1, dim)).astype(np.float32)
    n_real = np.unique(ids).size
    grads[n_real:capacity] = 0.0
    return table, accum, uids, grads


CASES = {"pads": (2000, 16, 300, 512), "overflow": (3000, 24, 900, 256),
         "exact fit": (500, 8, 5000, 500)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_push_matches_reference_fused_push(case):
    table, accum, uids, grads = _push_case(1, *CASES[case])
    cap = uids.shape[0]
    ws = tbe.WorkingSet(torch.from_numpy(uids), None, None, None)
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    opt = SparseAdagrad(SparseAdagradConfig(lr=LR, eps=EPS))
    ops.reset_launches()
    out = tbe.GatherBackend(fused=True).push(t, a, (), ws,
                                             torch.from_numpy(grads), opt)
    assert out[0] is t and out[1] is a                  # in place
    assert ops.launches["sparse_adagrad_apply_ref"] == 1
    jws = jbe.WorkingSet(jnp.asarray(uids), None, None, None)
    jt, ja, _ = jbe.GatherBackend(fused=True).push(
        jnp.asarray(table), jnp.asarray(accum), (), jws, jnp.asarray(grads),
        JSparseAdagrad(JSparseConfig(lr=LR, eps=EPS)))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    untouched = np.setdiff1d(np.arange(table.shape[0]), uids)
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])
    np.testing.assert_array_equal(a.numpy()[untouched], accum[untouched])
    # the drop row's gradient (row cap) was discarded: with it applied to
    # some row, the result would differ
    assert grads[cap].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_updates_match_reference(case):
    table, accum, uids, grads = _push_case(2, *CASES[case])
    rows = accum[uids]
    g = grads[:uids.shape[0]]
    delta, g2 = adagrad_row_updates(torch.from_numpy(rows),
                                    torch.from_numpy(g), torch.float32,
                                    lr=LR, eps=EPS)
    from repro.kernels.sparse_adagrad import adagrad_row_updates as jrows
    jdelta, jg2 = jax.jit(lambda r, g: jrows(r, g, jnp.float32, lr=LR,
                                             eps=EPS))(rows, g)
    np.testing.assert_array_equal(g2.numpy(), np.asarray(jg2))
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), rtol=1e-6,
                               atol=1e-9)
    # the pads' updates are -0.0 and +0.0, which change no bits
    pads = np.flatnonzero(np.r_[False, uids[1:] <= uids[:-1]])
    if pads.size:
        assert np.all(np.signbit(delta.numpy()[pads]))
        assert not g2.numpy()[pads].any()


def _apply_with_pad_rule(table, accum, uids, delta, g2):
    """The CUDA push kernel's rule, row by row: skip every position i > 0
    with uids[i] <= uids[i-1] (the pads), add the rest."""
    for i, u in enumerate(uids.tolist()):
        if i > 0 and u <= int(uids[i - 1]):
            continue
        table[u] = table[u] + delta[i]
        accum[u] = accum[u] + g2[i]
    return table, accum


@pytest.mark.parametrize("case", sorted(CASES))
def test_pad_rule_gives_the_plain_push_bit_for_bit(case):
    table, accum, uids, grads = _push_case(3, *CASES[case])
    t_uids = torch.from_numpy(uids)
    delta, g2 = adagrad_row_updates(
        torch.from_numpy(accum)[t_uids.long()],
        torch.from_numpy(grads[:uids.shape[0]]), torch.float32, lr=LR,
        eps=EPS)
    want = tref.sparse_adagrad_apply_ref(
        torch.from_numpy(table.copy()), torch.from_numpy(accum.copy()),
        t_uids, delta, g2)
    got = _apply_with_pad_rule(torch.from_numpy(table.copy()),
                               torch.from_numpy(accum.copy()), t_uids, delta,
                               g2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    n_pads = int((uids[1:] <= uids[:-1]).sum())
    assert n_pads == max(0, uids.shape[0] - np.unique(uids).size)
    assert (n_pads > 0) == (case == "pads")


def test_apply_rows_unfused_is_the_fused_bits_and_dense_reference():
    table, accum, uids, grads = _push_case(4, *CASES["pads"])
    opt = SparseAdagrad(SparseAdagradConfig(lr=LR, eps=EPS))
    ids, rg = torch.from_numpy(uids), torch.from_numpy(grads[:uids.shape[0]])
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    opt.apply_rows(t, a, ids, rg, fused=True)
    tables = {"t": torch.from_numpy(table.copy())}
    state = SparseAdagradState({"t": torch.from_numpy(accum.copy())})
    opt.step(tables, state, {"t": (ids, rg)})          # the unfused scatter
    outs = [(t, a), (tables["t"], state.accum["t"])]
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    # against the dense AdaGrad oracle on a full-size gradient
    full = np.zeros_like(table)
    n = np.unique(uids).size
    full[uids[:n]] = grads[:n]
    dt, da = opt.dense_reference(torch.from_numpy(table),
                                 torch.from_numpy(accum),
                                 torch.from_numpy(full))
    np.testing.assert_allclose(outs[0][0].numpy(), dt.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(outs[0][1].numpy(), da.numpy(), rtol=1e-6)


# ------------------------------------------------------------ the slice e2e
def _pair(k=2, n_pod=2, merge="flat", steps=6):
    """The reference trainer and the port's, from one state, after
    ``fit_online`` over the same 6 batches."""
    jtr = jbuild_trainer(
        "baidu-ctr", JTrainerConfig(n_pod=n_pod, kstep=JKStepConfig(
            k=k, merge=merge), capacity=256, fused_kernels=True, log_every=1),
        seed=3)
    state = from_reference(
        jax.device_get(jtr.dense), jax.device_get(jtr.tables),
        jax.device_get(jtr.sparse_state.accum),
        jax.device_get(jtr.opt_state), device="cpu")
    tcfg = TrainerConfig(n_pod=n_pod, kstep=KStepConfig(k=k, merge=merge),
                         capacity=256, fused_kernels=True, log_every=1)
    tr = HybridTrainer(None, build_ctr_engine(SMOKE, tcfg, device="cpu"),
                       R.ctr_embed_from_workings(SMOKE),
                       R.ctr_hybrid_loss(SMOKE), tcfg, state=state,
                       device="cpu")
    jh, jauc = jfit_online(jtr, JS.recsys_batches(JSMOKE, batch=32, seed=5),
                           steps, window=5)
    ops.reset_launches()
    h, auc = fit_online(tr, S.recsys_batches(SMOKE, batch=32, seed=5), steps,
                        window=5)
    return tr, h, auc, jtr, jh, jauc


def _by_key(tree, prefix=""):
    """{path: numpy leaf} of a dict/list tree (both frameworks' trees)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_key(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_by_key(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree.detach().numpy() if isinstance(
        tree, torch.Tensor) else tree)}


def _assert_trees_close(got, want, **tol):
    g, w = _by_key(got), _by_key(jax.device_get(want))
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


def test_training_slice_matches_reference_end_to_end():
    tr, h, auc, jtr, jh, jauc = _pair()
    assert [r["step"] for r in h] == [r["step"] for r in jh] == list(
        range(1, 7))
    np.testing.assert_allclose([r["loss"] for r in h],
                               [r["loss"] for r in jh], **SLICE)
    np.testing.assert_allclose([r["auc"] for r in h],
                               [r["auc"] for r in jh], **SLICE)
    np.testing.assert_allclose(auc, jauc, **SLICE)
    assert tr.step_num == jtr.step_num == 6
    assert tr.overflow_dropped == jtr.overflow_dropped > 0
    assert [r["overflow_dropped"] for r in h] == [
        r["overflow_dropped"] for r in jh]
    _assert_trees_close(tr.dense, jtr.dense, **SLICE)
    _assert_trees_close(tr.tables, jtr.tables, **SLICE)
    _assert_trees_close(tr.sparse_state.accum, jtr.sparse_state.accum,
                        **SLICE)
    for f in ("m", "v_local", "v_hat"):
        _assert_trees_close(getattr(tr.opt_state, f),
                            getattr(jtr.opt_state, f), **SLICE)
    assert int(tr.opt_state.step) == int(jtr.opt_state.step) == 6
    # the CPU path ran every plain version, once per use
    assert ops.launches == {
        "embedding_bag": 0, "embedding_bag_ref": 6 * (1 + 2),
        "embedding_bag_backward": 0, "embedding_bag_backward_ref": 6 * 2,
        "sparse_adagrad_apply": 0, "sparse_adagrad_apply_ref": 6}


def test_training_slice_int8_ef_merge_matches_reference():
    tr, h, auc, jtr, jh, jauc = _pair(k=3, n_pod=4, merge="int8_ef",
                                      steps=4)
    np.testing.assert_allclose([r["loss"] for r in h],
                               [r["loss"] for r in jh], **SLICE)
    _assert_trees_close(tr.dense, jtr.dense, **SLICE)
    _assert_trees_close(tr.opt_state.ef, jtr.opt_state.ef, rtol=1e-4,
                        atol=1e-5)


def _run(serve, steps=6):
    tcfg = TrainerConfig(n_pod=2, kstep=KStepConfig(k=2), capacity=256,
                         log_every=1)
    tr = build_trainer("baidu-ctr", tcfg, seed=7, device="cpu")
    srv = build_ctr_server(tr, max_batch=16) if serve else None
    gen = S.recsys_batches(SMOKE, batch=32, seed=5)
    serve_gen = S.recsys_batches(SMOKE, batch=16, seed=2)
    losses = []
    for _ in range(steps):
        if srv is not None:
            srv.submit_batch(next(serve_gen))
        losses.append(tr.train_step(next(gen)))
        if srv is not None:
            assert srv.drain() == 16
    return tr, torch.stack(losses)


def test_serving_does_not_change_training():
    """The co-located server reads the live tables between steps; the loss
    trajectory and the final state are bit-identical to a run without it."""
    a, la = _run(serve=False)
    b, lb = _run(serve=True)
    assert torch.equal(la, lb)
    assert torch.equal(a.tables["sparse"], b.tables["sparse"])
    assert torch.equal(a.sparse_state.accum["sparse"],
                       b.sparse_state.accum["sparse"])
    for x, y in zip(_by_key(a.dense).values(), _by_key(b.dense).values()):
        np.testing.assert_array_equal(x, y)
    assert b.serve_metrics()["serve_requests"] == 6 * 16


def test_fit_logs_and_suggests_capacity():
    tcfg = TrainerConfig(n_pod=2, kstep=KStepConfig(k=2), capacity=64,
                         log_every=2)
    tr = build_trainer("baidu-ctr", tcfg, seed=1, device="cpu")
    hist = tr.fit(S.recsys_batches(SMOKE, batch=16, seed=3), 4)
    assert [r["step"] for r in hist] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert sum(r["overflow_dropped"] for r in hist) == tr.overflow_dropped
    assert hist[-1]["overflow_dropped_total"] == tr.overflow_dropped > 0
    assert tr.suggest_capacity() > 64
    assert tr.sparse_metrics()["overflow_dropped"] == 0   # a pure read


def test_unported_knobs_raise():
    with pytest.raises(NotImplementedError, match="strict_transfers"):
        fit_online(build_trainer("baidu-ctr", TrainerConfig(), device="cpu"),
                   iter([]), 1, strict_transfers=True)
    with pytest.raises(NotImplementedError, match="A4"):
        build_trainer("baidu-ctr", TrainerConfig(placement="cached"),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        build_trainer("baidu-ctr", TrainerConfig(placement="routed"),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="SSD"):
        build_trainer("baidu-ctr", TrainerConfig(store="disk"), device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        S.recsys_batches(object(), batch=4)
    with pytest.raises(ValueError, match="n_pod"):
        build_trainer("baidu-ctr", TrainerConfig(n_pod=3),
                      device="cpu").train_step(
            next(S.recsys_batches(SMOKE, batch=4)))
    opt = SparseAdagrad()
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_fused(False, "cuda")
    assert opt.cfg.initial_accumulator == 0.1


def test_init_functions_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    gen = torch.Generator("cpu").manual_seed(0)
    with pytest.raises(RuntimeError, match="cuda"):
        common.he_init(gen, (4, 4))
    with pytest.raises(RuntimeError, match="cuda"):
        common.mlp_init(gen, [4, 2])
    with pytest.raises(RuntimeError, match="cuda"):
        R.ctr_init_dense(gen, SMOKE)
    dense = R.ctr_init_dense(gen, SMOKE, device="cpu")
    assert dense["mlp"][0]["w"].device.type == "cpu"


# ------------------------------------------------------------------ launcher
def _launch(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(list(argv))
    return out.getvalue().strip().splitlines()


def _final_loss(line):
    assert line.startswith("final loss ")
    return float(line.split()[2])


def test_launcher_trains_on_the_cpu():
    """The command line, run as a user runs it."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "baidu-ctr", "--steps", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert np.isfinite(_final_loss(last))
    assert "overflow_dropped 0" in last and "online AUC" in last


def test_launcher_serve_and_flags():
    last = _launch("--arch", "baidu-ctr", "--steps", "3", "--device", "cpu",
                   "--serve", "--serve-batch", "8", "--k", "2", "--merge",
                   "int8_ef", "--batch", "16")[-1]
    assert np.isfinite(_final_loss(last)) and "served 24" in last
    for flags, err in ((["--prefetch"], NotImplementedError),
                       (["--ckpt-dir", "ckpt"], NotImplementedError),
                       (["--store", "disk"], NotImplementedError),
                       (["--cache-rows", "64"], NotImplementedError),
                       (["--strict-transfers"], NotImplementedError),
                       (["--placement", "routed"], NotImplementedError),
                       (["--merge-delay", "1"], ValueError)):
        with pytest.raises(err):
            _launch("--arch", "baidu-ctr", "--steps", "1", "--device", "cpu",
                    *flags)
    with pytest.raises(KeyError, match="not in the port"):
        _launch("--arch", "dlrm-mlperf", "--steps", "1", "--device", "cpu")
