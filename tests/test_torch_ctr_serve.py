"""The port's baidu-ctr serving slice against the reference, end to end.

Both sides start from one state: the reference trainer's parameters,
exported as numpy and loaded through ``repro_torch.interop``.  Both
``CTRServer``s then score the same ``ctr_batches`` requests (the port's
stream is byte-identical to the reference's), with a padded tail batch and
a capacity small enough that some ids overflow into the drop row.  Scores
agree within atol = rtol = 1e-5 (float32, different summation orders in the
matmuls); the serve meters are equal.  The reference runs its bag through
the Pallas kernel in interpret mode (``fused_kernels=True`` under
``REPRO_KERNEL_INTERPRET=1``), the port through its plain version.
"""

import tempfile

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic as JS
from repro.models import recsys as JR
from repro.runtime.factory import build_ctr_server as jbuild_server
from repro.runtime.factory import build_trainer as jbuild_trainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.data import synthetic as S
from repro_torch.interop import from_reference
from repro_torch.models import recsys as R
from repro_torch.runtime.factory import (
    build_ctr_engine,
    build_ctr_server,
    build_trainer,
)
from repro_torch.runtime.metrics import auc
from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig

torch.set_num_threads(1)

SMOKE = configs.get("baidu-ctr").smoke_cfg
JSMOKE = jconfigs.get("baidu-ctr").smoke_cfg
TOL = dict(atol=1e-5, rtol=1e-5)


def test_smoke_and_model_configs_match_the_reference():
    for name in ("smoke_cfg", "model_cfg"):
        got = getattr(configs.get("baidu-ctr"), name)
        want = getattr(jconfigs.get("baidu-ctr"), name)
        for f in ("name", "rows", "embed_dim", "n_fields", "nnz_per_instance",
                  "attn_heads", "mlp"):
            assert getattr(got, f) == getattr(want, f)
    assert configs.get("baidu-ctr").shapes["serve_online"].dims == {
        "batch": 1024}
    # gin-tu, unregistered until A10e, now resolves to the reference's
    assert configs.get("gin-tu").family == jconfigs.get("gin-tu").family
    with pytest.raises(KeyError, match="not in the port"):
        configs.get("no-such-arch")


def test_ctr_forward_matches_reference():
    dense_np = jax.device_get(JR.ctr_init_dense(jax.random.key(3), JSMOKE))
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((12, SMOKE.n_fields, SMOKE.embed_dim)).astype(
        np.float32)
    state = from_reference({"d": dense_np}, {}, {}, device="cpu")
    got = R.ctr_forward_from_emb(state.dense["d"], torch.from_numpy(emb), {},
                                 SMOKE).numpy()
    want = np.asarray(JR.ctr_forward_from_emb(dense_np, emb, {}, JSMOKE))
    np.testing.assert_allclose(got, want, **TOL)
    labels = (rng.random(12) < 0.5).astype(np.float32)
    loss = R.ctr_hybrid_loss(SMOKE)(state.dense["d"], torch.from_numpy(emb),
                                    {"label": torch.from_numpy(labels)})
    jloss = JR.ctr_hybrid_loss(JSMOKE)(dense_np, emb, {"label": labels})
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


def test_ctr_batches_stream_is_byte_identical():
    got = S.ctr_batches(seed=2, batch=64, rows=SMOKE.rows, n_fields=8, nnz=20)
    want = JS.ctr_batches(seed=2, batch=64, rows=SMOKE.rows, n_fields=8,
                          nnz=20)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


def _requests(n_full, tail, batch):
    stream = S.ctr_batches(seed=2, batch=batch, rows=SMOKE.rows,
                           n_fields=SMOKE.n_fields,
                           nnz=SMOKE.nnz_per_instance)
    batches = [next(stream) for _ in range(n_full + 1)]
    batches[-1] = {k: v[:tail] for k, v in batches[-1].items()}
    return batches


def _serve(server, batches):
    reqs = []
    for b in batches:
        server.submit_batch(b)
        reqs.extend(server.pending)
        server.drain()
    return np.array([r.score for r in reqs])


def test_serving_slice_matches_reference_end_to_end():
    capacity, max_batch = 256, 32
    jtr = jbuild_trainer(
        "baidu-ctr", JTrainerConfig(placement="gather", fused_kernels=True,
                                    capacity=capacity))
    state = from_reference(jax.device_get(jtr.dense),
                           jax.device_get(jtr.tables),
                           jax.device_get(jtr.sparse_state.accum),
                           device="cpu")
    tcfg = TrainerConfig(placement="gather", capacity=capacity)
    tr = HybridTrainer(
        None, build_ctr_engine(SMOKE, tcfg, device="cpu"),
        R.ctr_embed_from_workings(SMOKE), R.ctr_hybrid_loss(SMOKE), tcfg,
        state=state, device="cpu")

    batches = _requests(3, 10, max_batch)
    got = _serve(build_ctr_server(tr, max_batch=max_batch), batches)
    want = _serve(jbuild_server(jtr, max_batch=max_batch), batches)
    assert got.shape == want.shape == (3 * max_batch + 10,)
    assert np.isfinite(got).all() and ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, **TOL)

    m, jm = tr.serve_metrics(), jtr.serve_metrics()
    assert m["serve_requests"] == jm["serve_requests"] == 4 * max_batch
    assert m["serve_lookups"] == jm["serve_lookups"]
    slots = 4 * max_batch * SMOKE.nnz_per_instance
    assert m["serve_lookups"] < slots     # the capacity dropped some ids
    labels = np.concatenate([b["label"] for b in batches])
    assert auc(labels, got) == pytest.approx(auc(labels, want), abs=1e-3)


def test_build_trainer_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        build_trainer("baidu-ctr", TrainerConfig(placement="gather"))
    with pytest.raises(RuntimeError, match="cuda"):
        from_reference({}, {}, {})


def test_factory_trainer_on_cpu_serves_and_refuses_training():
    tr = build_trainer("baidu-ctr", TrainerConfig(placement="gather"),
                       device="cpu")
    assert tr.engine.capacity == 16384            # next_pow2(min(1<<14, rows))
    assert tr.tables["sparse"].shape == (SMOKE.rows, SMOKE.embed_dim)
    assert tr.dense["wq"].shape == (1, SMOKE.embed_dim, SMOKE.embed_dim)
    batch = _requests(1, 1, 8)[0]
    scores = tr.predict(batch)
    assert scores.shape == (8,) and np.isfinite(scores).all()
    loss = tr.train_step(batch)
    assert tr.step_num == 1 and np.isfinite(float(loss))
    # checkpoints (A3) are ported: the knob gives the trainer a manager
    with tempfile.TemporaryDirectory() as d:
        tr = build_trainer("baidu-ctr", TrainerConfig(ckpt_dir=d),
                           device="cpu")
        assert tr.ckpt is not None and tr.ckpt.directory == d
        assert not tr.resume()            # nothing saved yet
    # the pull prefetch (A5) is ported: a prefetched trainer serves with a
    # pull in flight and trains on it
    tr = build_trainer("baidu-ctr", TrainerConfig(prefetch=True),
                       device="cpu")
    assert tr.prefetch(batch) and tr._prefetcher.pending is not None
    np.testing.assert_array_equal(tr.predict(batch), scores)
    loss = tr.train_step(batch)
    assert tr.step_num == 1 and np.isfinite(float(loss))
    assert tr._prefetcher.pending is None
    for knobs, err in (({"merge_delay": 1}, ValueError),
                       ({"merge_quorum": 0.5}, NotImplementedError)):
        with pytest.raises(err):
            build_trainer("baidu-ctr", TrainerConfig(**knobs), device="cpu")
    with pytest.raises(TypeError, match="HybridTrainer"):
        build_ctr_server(object())
