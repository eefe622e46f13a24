"""The port's input pipeline (``repro_torch.data.pipeline``) against the
reference's (``repro.data.pipeline``), on one seeded numpy source, on the
CPU: the same items in the same order, the same counts, the same failure
contract (a raising source or ``stage_fn`` re-raised on the consumer as
``RuntimeError`` from its cause, on that ``next`` and every later one), a
joined producer after ``close``, and ``serialized_baseline``.  Then a
pipeline-fed prefetched ``fit`` against a directly fed synchronous one:
bit-equal (the pipeline only moves where the batches are made)."""

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.core.kstep import KStepConfig
from repro_torch.core.sparse_optim import SparseAdagradConfig
from repro_torch.data import PrefetchPipeline
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as S
from repro_torch.runtime.factory import build_trainer
from repro_torch.runtime.trainer import TrainerConfig

torch.set_num_threads(1)


def _source(n=12, seed=5):
    rng = np.random.default_rng(seed)
    for i in range(n):
        yield {"ids": rng.integers(0, 1000, (16, 4)), "step": np.int64(i)}


def _stage(b):
    return {k: v * 2 for k, v in b.items()}


@pytest.mark.parametrize("depth", [1, 2, 5])
@pytest.mark.parametrize("staged", [False, True])
def test_same_items_in_the_same_order(depth, staged):
    fn = _stage if staged else None
    got = tpipe.PrefetchPipeline(_source(), depth=depth, stage_fn=fn)
    want = jpipe.PrefetchPipeline(_source(), depth=depth, stage_fn=fn)
    a, b = list(got), list(want)
    assert len(a) == len(b) == 12
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    # the end-of-stream sentinel is counted, as in the reference
    assert got.batches == want.batches == 13
    assert got.read_seconds >= 0.0 and got.wait_seconds >= 0.0
    for p in (got, want):
        p.close()
        assert not p._thread.is_alive()


def _failing_source():
    yield 1
    yield 2
    raise ValueError("disk gone")


def _bad_stage(x):
    if x == 3:
        raise KeyError("bad batch")
    return x


@pytest.mark.parametrize("mod", [tpipe, jpipe], ids=["port", "reference"])
@pytest.mark.parametrize("case", ["source", "stage_fn"])
def test_producer_failure_reraised_on_every_next(mod, case):
    if case == "source":
        pipe = mod.PrefetchPipeline(_failing_source(), depth=2)
        good, cause, msg = [1, 2], ValueError, "disk gone"
    else:
        pipe = mod.PrefetchPipeline(iter(range(6)), depth=2,
                                    stage_fn=_bad_stage)
        good, cause, msg = [0, 1, 2], KeyError, "bad batch"
    assert [next(pipe) for _ in good] == good
    for _ in range(3):   # sticky: never blocks on the dead producer
        with pytest.raises(RuntimeError, match="producer failed") as ei:
            next(pipe)
        assert isinstance(ei.value.__cause__, cause)
        assert msg in str(ei.value.__cause__)
    pipe.close()
    assert not pipe._thread.is_alive()


def test_close_joins_the_producer():
    for mod in (tpipe, jpipe):
        pipe = mod.PrefetchPipeline(iter(range(10_000)), depth=2)
        assert next(pipe) == 0
        pipe.close()
        assert not pipe._thread.is_alive()


def test_serialized_baseline_matches_the_reference():
    out, secs = tpipe.serialized_baseline(iter(range(5)), lambda x: x + 1, 5)
    jout, jsecs = jpipe.serialized_baseline(iter(range(5)), lambda x: x + 1,
                                            5)
    assert out == jout == [1, 2, 3, 4, 5]
    assert secs >= 0.0 and jsecs >= 0.0


def test_stage_batch_on_the_cpu():
    """The trainers' staging: numpy leaves become CPU tensors of the same
    dtype and values, tensors already there pass as they are."""
    b = next(_source())
    t = torch.arange(4)
    out = tpipe.stage_batch({**b, "t": t}, "cpu")
    assert out["ids"].dtype == torch.from_numpy(b["ids"]).dtype
    np.testing.assert_array_equal(out["ids"].numpy(), b["ids"])
    assert out["t"] is t


@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_pipeline_fed_prefetched_fit_is_the_direct_sync_fit(placement):
    gen = S.ctr_batches(seed=9, batch=256, rows=20_000, n_fields=8, nnz=20,
                        zipf_a=1.05)
    batches = [next(gen) for _ in range(8)]
    runs = []
    for prefetch in (False, True):
        tcfg = TrainerConfig(
            n_pod=2, kstep=KStepConfig(lr=1e-3, k=5),
            sparse=SparseAdagradConfig(lr=0.5, initial_accumulator=0.01),
            placement=placement, capacity=4096,
            cache_rows=4096 if placement == "cached" else None,
            prefetch=prefetch, log_every=2)
        tr = build_trainer("baidu-ctr", tcfg, device="cpu")
        if prefetch:
            pipe = PrefetchPipeline(iter(batches), depth=2,
                                    stage_fn=lambda b: tpipe.stage_batch(
                                        b, "cpu"))
            hist = tr.fit(pipe, 8)
            assert pipe.batches == 8      # fit draws exactly its steps
            pipe.close()
        else:
            hist = tr.fit(iter(batches), 8)
        runs.append((tr, hist))
    (ta, ha), (tb, hb) = runs
    assert [{k: v for k, v in r.items() if k != "sec"} for r in ha] == \
        [{k: v for k, v in r.items() if k != "sec"} for r in hb]
    assert _leaves(ta.dense)
    for x, y in ((ta.dense, tb.dense), (ta.tables, tb.tables),
                 (ta.sparse_state.accum, tb.sparse_state.accum),
                 (ta.backend_state, tb.backend_state)):
        xs, ys = _leaves(x), _leaves(y)
        assert len(xs) == len(ys)
        assert all(torch.equal(u, v) for u, v in zip(xs, ys))


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []
