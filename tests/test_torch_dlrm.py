"""The port's DLRM serving slice against the reference (its training:
``tests/test_torch_dlrm_train.py``).

Both sides start from one state: the reference trainer's parameters,
exported as numpy and loaded through ``repro_torch.interop``; the requests
come from ``dlrm_batches``, whose stream is byte-identical in the two
packages.  Tolerances:
- the dot interaction: the reference kernel test's own
  (``tests/test_kernels.py``): atol 1e-5 * D and rtol 4e-5 in float32,
  atol 2e-2 * D and rtol 8e-2 in bfloat16 (sums taken in other orders);
- the forward and the scores: atol = rtol = 1e-5 at smoke size and atol
  1e-5 at the published widths (float32, the matmuls sum in other orders).
The reference's interaction kernel runs in interpret mode; its model path
calls the jnp ``dot_interaction``, the port's ``ops.dot_interaction`` (the
plain version on the CPU).
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
from repro.data import synthetic as JS
from repro.kernels import ref as jref
from repro.kernels.dot_interaction import dot_interaction_pallas
from repro.models import recsys as JR
from repro.runtime.factory import build_ctr_server as jbuild_server
from repro.runtime.factory import build_trainer as jbuild_trainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.data import synthetic as S
from repro_torch.interop import from_reference
from repro_torch.kernels import dot_interaction as tdot
from repro_torch.kernels import ops
from repro_torch.launch import train as launch
from repro_torch.models import recsys as R
from repro_torch.runtime import factory
from repro_torch.runtime.factory import (
    build_ctr_server,
    build_dlrm_engine,
    build_trainer,
)
from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

torch.set_num_threads(1)

SMOKE = configs.get("dlrm-mlperf").smoke_cfg
JSMOKE = jconfigs.get("dlrm-mlperf").smoke_cfg
TOL = dict(atol=1e-5, rtol=1e-5)
KTOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py's TOL
ROW_CAP = 1000                               # rows per table, full width


def _capped(model_cfg, cap):
    return dataclasses.replace(
        model_cfg, rows=tuple(min(r, cap) for r in model_cfg.rows))


def test_configs_match_the_reference():
    for name in ("smoke_cfg", "model_cfg"):
        got = getattr(configs.get("dlrm-mlperf"), name)
        want = getattr(jconfigs.get("dlrm-mlperf"), name)
        for f in ("name", "n_dense", "n_sparse", "embed_dim", "bot_mlp",
                  "top_mlp", "rows", "interact_dim"):
            assert getattr(got, f) == getattr(want, f), (name, f)
    model = configs.get("dlrm-mlperf").model_cfg
    assert model.interact_dim == 479 and sum(model.rows) == 187_767_399
    assert sum(_capped(model, 8_000_000).rows) == 44_063_992
    assert R.CRITEO_ROWS == JR.CRITEO_ROWS
    got, want = configs.recsys_shapes(), jconfigs.recsys_shapes()
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k].kind, got[k].dims) == (want[k].kind, want[k].dims)
    assert {k: v.dims["batch"] for k, v in got.items()
            if k != "retrieval_cand"} == {
        "train_batch": 65536, "serve_p99": 512, "serve_bulk": 262144}
    spec, jspec = configs.get("dlrm-mlperf"), jconfigs.get("dlrm-mlperf")
    assert (spec.family, spec.source) == (jspec.family, jspec.source)


def _feats(B, F, D, dtype, seed=1):
    """One numpy draw as the reference and the port take it (bfloat16: the
    float32 values rounded to bfloat16 once, by JAX)."""
    x = np.random.default_rng(seed).standard_normal((B, F, D))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,F,D,blk", [
    (64, 27, 32, 32), (128, 27, 128, 64), (32, 8, 16, 32),
    (256, 13, 64, 128), (16, 2, 8, 16),
])
def test_dot_interaction_matches_the_reference(dtype, B, F, D, blk):
    jx, tx = _feats(B, F, D, dtype)
    ops.reset_launches()
    got = ops.dot_interaction(tx)
    assert ops.launches["dot_interaction_ref"] == 1
    assert ops.launches["dot_interaction"] == 0
    assert got.dtype == tx.dtype and got.shape == (B, F * (F - 1) // 2)
    got = got.to(torch.float32).numpy()
    tol = dict(atol=KTOL[dtype] * D, rtol=KTOL[dtype] * 4)
    pallas = dot_interaction_pallas(jx, batch_block=blk, interpret=True)
    for want in (pallas, jref.dot_interaction_ref(jx)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)
    # column p is the dot of the p-th pair of np.tril_indices(F, k=-1)
    x = tx.to(torch.float64).numpy()
    li, lj = np.tril_indices(F, k=-1)
    for p in range(len(li)):
        np.testing.assert_allclose(
            got[:, p], np.einsum("bd,bd->b", x[:, li[p]], x[:, lj[p]]), **tol)


def test_dot_interaction_edge_shapes_and_cpu_gradient():
    assert ops.dot_interaction(torch.ones(3, 1, 4)).shape == (3, 0)
    assert ops.dot_interaction(torch.ones(0, 5, 4)).shape == (0, 10)
    jx, tx = _feats(6, 5, 7, "float32", seed=3)
    tx.requires_grad_(True)
    g = np.random.default_rng(4).standard_normal((6, 10)).astype(np.float32)
    (ops.dot_interaction(tx) * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(JR.dot_interaction, jx)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(g)[0]),
                               atol=1e-5 * 7, rtol=4e-5)
    with pytest.raises(ValueError, match="CUDA"):
        tdot.dot_interaction_cuda(tx.detach())


def test_dlrm_batches_stream_is_byte_identical():
    got = S.recsys_batches(SMOKE, batch=64, seed=2)
    want = JS.recsys_batches(JSMOKE, batch=64, seed=2)
    full = S.dlrm_batches(seed=5, batch=32, rows=R.CRITEO_ROWS, worker=1)
    jfull = JS.dlrm_batches(seed=5, batch=32, rows=JR.CRITEO_ROWS, worker=1)
    for _ in range(3):
        for a, b in ((next(got), next(want)), (next(full), next(jfull))):
            assert a.keys() == b.keys() == {"dense", "sparse_ids", "label"}
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("width", ["smoke", "full"])
def test_dlrm_forward_matches_the_reference(width):
    jcfg = JSMOKE if width == "smoke" else jconfigs.get("dlrm-mlperf").model_cfg
    cfg = SMOKE if width == "smoke" else configs.get("dlrm-mlperf").model_cfg
    dense_np = jax.device_get(JR.dlrm_init_dense(jax.random.key(3), jcfg))
    rng = np.random.default_rng(0)
    emb = (0.05 * rng.standard_normal((12, cfg.n_sparse, cfg.embed_dim))
           ).astype(np.float32)
    batch = {"dense": rng.standard_normal((12, cfg.n_dense)).astype(
        np.float32)}
    state = from_reference({"d": dense_np}, {}, {}, device="cpu")
    assert [lay["w"].shape[0] for lay in state.dense["d"]["top"]][0] == (
        cfg.interact_dim)
    got = R.dlrm_forward_from_emb(
        state.dense["d"], torch.from_numpy(emb),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg).numpy()
    want = np.asarray(JR.dlrm_forward_from_emb(dense_np, emb, batch, jcfg))
    np.testing.assert_allclose(got, want, **TOL)


def test_from_reference_carries_the_dlrm_state():
    jtr = jbuild_trainer("dlrm-mlperf", JTrainerConfig(placement="gather"))
    dense, tables = jax.device_get(jtr.dense), jax.device_get(jtr.tables)
    state = from_reference(dense, tables,
                           jax.device_get(jtr.sparse_state.accum),
                           device="cpu")
    assert set(state.dense) == {"bot", "top"}
    assert len(state.dense["bot"]) == len(SMOKE.bot_mlp) - 1
    assert len(state.dense["top"]) == len(SMOKE.top_mlp)
    for name in ("bot", "top"):
        for got, want in zip(state.dense[name], dense[name]):
            for k in ("w", "b"):
                assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    assert sorted(state.tables) == [f"emb_{i:02d}" for i in range(26)]
    for n, t in state.tables.items():
        assert t.shape == (200, SMOKE.embed_dim)
        assert np.array_equal(t.numpy(), np.asarray(tables[n]))
        assert np.array_equal(state.accum[n].numpy(),
                              np.asarray(jtr.sparse_state.accum[n]))


def _pair(model_cfg, jmodel_cfg, capacity):
    """The reference trainer and the port's, on the CPU, from one state."""
    jtr = jbuild_trainer(
        "dlrm-mlperf", JTrainerConfig(placement="gather", capacity=capacity),
        model_cfg=jmodel_cfg)
    state = from_reference(jax.device_get(jtr.dense),
                           jax.device_get(jtr.tables),
                           jax.device_get(jtr.sparse_state.accum),
                           device="cpu")
    tcfg = TrainerConfig(placement="gather", capacity=capacity)
    tr = HybridTrainer(
        None, build_dlrm_engine(model_cfg, tcfg, device="cpu"),
        R.dlrm_embed_from_workings(model_cfg), R.dlrm_hybrid_loss(model_cfg),
        tcfg, state=state, device="cpu")
    return jtr, tr


def _serve(server, batches):
    reqs = []
    for b in batches:
        server.submit_batch(b)
        reqs.extend(server.pending)
        server.drain()
    return np.array([r.score for r in reqs])


def test_serving_matches_the_reference_end_to_end():
    capacity, max_batch = 32, 64
    jtr, tr = _pair(SMOKE, JSMOKE, capacity)
    stream = S.dlrm_batches(seed=2, batch=max_batch, rows=SMOKE.rows)
    batches = [next(stream) for _ in range(4)]
    batches[-1] = {k: v[:10] for k, v in batches[-1].items()}
    ops.reset_launches()
    server = build_ctr_server(tr, max_batch=max_batch)
    got = _serve(server, batches)
    assert ops.launches["dot_interaction_ref"] == 4
    jserver = jbuild_server(jtr, max_batch=max_batch)
    want = _serve(jserver, batches)
    assert got.shape == want.shape == (3 * max_batch + 10,)
    assert np.isfinite(got).all() and ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, **TOL)
    # the tail pads (copies of instance 0) are scored but not served
    assert server.stats["served"] == jserver.stats["served"] == 3 * 64 + 10
    assert server.stats["steps"] == jserver.stats["steps"] == 4
    m, jm = tr.serve_metrics(), jtr.serve_metrics()
    assert m["serve_requests"] == jm["serve_requests"] == 4 * max_batch
    assert m["serve_lookups"] == jm["serve_lookups"]
    assert m["serve_lookups"] < 4 * max_batch * 26   # the capacity dropped ids
    # the working-set path equals the full-table oracle where nothing drops
    b = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    wss, _ = tr.engine.lookup_batch(tr.tables, tr.sparse_state.accum,
                                    tr.backend_state, b)
    emb = R.dlrm_embed_from_workings(SMOKE)(
        {n: ws.rows for n, ws in wss.items()},
        {n: ws.inverse for n, ws in wss.items()}, b)
    oracle = R.dlrm_embed_batch(tr.tables, b, SMOKE)
    kept = torch.stack([wss[f"emb_{i:02d}"].inverse < capacity
                        for i in range(26)], dim=1)
    assert torch.equal(emb[kept], oracle[kept])
    assert not emb[~kept].any()                     # the zero drop row
    jemb = JR.dlrm_embed_batch(jtr.tables, batches[0], JSMOKE)
    assert np.array_equal(oracle.numpy(), np.asarray(jemb))


def test_full_width_serving_matches_the_reference():
    """The published widths (embed 128, bottom 13-512-256-128, top
    479-1024-1024-512-256-1), rows capped at 1000 a table, one serve_p99
    batch of 512 from one state."""
    model = _capped(configs.get("dlrm-mlperf").model_cfg, ROW_CAP)
    jmodel = _capped(jconfigs.get("dlrm-mlperf").model_cfg, ROW_CAP)
    jtr, tr = _pair(model, jmodel, None)
    assert tr.engine.capacity == jtr.engine.capacity == 1024
    assert tr.dense["top"][0]["w"].shape == (1, 479, 1024)
    max_batch = configs.get("dlrm-mlperf").shapes["serve_p99"].dims["batch"]
    batches = [next(S.dlrm_batches(seed=6, batch=max_batch,
                                   rows=model.rows))]
    got = _serve(build_ctr_server(tr, max_batch=max_batch), batches)
    want = _serve(jbuild_server(jtr, max_batch=max_batch), batches)
    assert got.shape == (max_batch,) and np.isfinite(got).all()
    assert np.ptp(got) > 1e-3                       # the scores vary
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_factory_defaults_to_cuda_and_names_unported_configs():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_trainer("dlrm-mlperf", TrainerConfig(placement="gather"))
    with pytest.raises(TypeError, match="unknown recsys model config"):
        factory._recsys_wiring(object())
