"""The port's working-set lookup (``repro_torch.core``) against the reference.

The dedup layout must equal the reference's ``jnp.unique(size=capacity,
fill_value=None)`` exactly: ``uids``, ``inverse`` and ``n_dropped`` are
compared for equality, including an overflow case (capacity below the
distinct count: the smallest ids are kept, pads repeat the minimum, cut
ids read the zero drop row).  Gathered rows are copies, so they are
compared for equality too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import embedding_backend as jbe
from repro.core.embedding_engine import EmbeddingEngine as JEngine
from repro.core.embedding_engine import TableSpec as JSpec
from repro_torch.core import embedding_backend as tbe
from repro_torch.core.embedding_engine import EmbeddingEngine, TableSpec
from repro_torch.core.row_store import make_store
from repro_torch.data.synthetic import _zipf_ids

torch.set_num_threads(1)

ROWS, DIM = 5000, 8


def _ids(seed, n=640):
    return _zipf_ids(np.random.default_rng(seed), (n,), ROWS).astype(np.int32)


def _table(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (ROWS, DIM)).astype(np.float32)


@pytest.mark.parametrize("capacity", [1024, 512, 64])
def test_dedup_equals_reference_exactly(capacity):
    ids = _ids(capacity)
    n_distinct = np.unique(ids).size
    uids, inv, nd = tbe._dedup(torch.from_numpy(ids), capacity)
    juids, jinv, jnd = jbe._dedup(jnp.asarray(ids), capacity)
    np.testing.assert_array_equal(uids.numpy(), np.asarray(juids))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert int(nd) == int(jnd)
    assert uids.dtype == inv.dtype == nd.dtype == torch.int32
    if capacity >= n_distinct:
        assert int(nd) == 0
        assert (uids.numpy()[n_distinct:] == ids.min()).all()
    else:
        kept = np.unique(ids)[:capacity]
        np.testing.assert_array_equal(uids.numpy(), kept)
        assert int(nd) == int((ids > kept[-1]).sum()) > 0
        assert (inv.numpy()[ids > kept[-1]] == capacity).all()


@pytest.mark.parametrize("capacity", [1024, 64])
def test_gather_lookup_equals_reference(capacity):
    ids, table = _ids(3), _table()
    accum = np.full_like(table, 0.1)
    ws, aux = tbe.GatherBackend().lookup(
        torch.from_numpy(table), torch.from_numpy(accum), (),
        torch.from_numpy(ids), capacity)
    jws, jaux = jbe.GatherBackend().lookup(
        jnp.asarray(table), jnp.asarray(accum), (), jnp.asarray(ids), capacity)
    for got, want in zip(ws, jws):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ws.rows.shape == (capacity + 1, DIM)
    assert not ws.rows[capacity].any()            # the drop row reads zero
    assert float(aux["serve_lookups"]) == float(jaux["serve_lookups"])


def _engines(capacity=64):
    spec = dict(rows=ROWS, dim=DIM, id_field="ids")
    eng = EmbeddingEngine({"sparse": TableSpec("sparse", **spec)}, capacity,
                          device="cpu")
    jeng = JEngine({"sparse": JSpec("sparse", **spec)}, capacity)
    return eng, jeng


def test_engine_lookup_batch_equals_reference_and_writes_nothing():
    eng, jeng = _engines()
    tables = {"sparse": torch.from_numpy(_table(1))}
    st = eng.init_state(tables)
    bstate = eng.init_backend_state(tables)
    before = [t.clone() for t in (tables["sparse"], st.accum["sparse"])]
    batch_np = {"ids": _ids(4, 320).reshape(16, 20)}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    wss, aux = eng.lookup_batch(tables, st.accum, bstate, batch)

    jtables = {"sparse": jnp.asarray(_table(1))}
    jwss, jaux = jeng.lookup_batch(
        jtables, jeng.init_state(jtables).accum,
        jeng.init_backend_state(jtables),
        {k: jnp.asarray(v) for k, v in batch_np.items()})
    for got, want in zip(wss["sparse"], jwss["sparse"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(aux["serve_lookups"]) == float(jaux["serve_lookups"])
    assert int(eng.overflow(wss)) == int(JEngine.overflow(jwss)) > 0
    after = (tables["sparse"], st.accum["sparse"])
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(st.accum["sparse"].numpy(), 0.1 * np.ones(
        (ROWS, DIM), np.float32))


def test_engine_memory_and_training_entry_points():
    """The training pull serves the rows the reference's pull serves (and
    the lookup serves); the push writes only the pulled rows."""
    eng, jeng = _engines()
    assert eng.memory_bytes() == jeng.memory_bytes()
    tables = {"sparse": torch.from_numpy(_table(2))}
    st = eng.init_state(tables)
    bstate = eng.init_backend_state(tables)
    batch_np = {"ids": _ids(5, 320).reshape(16, 20)}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    wss, t2, a2, s2 = eng.pull_stage()(tables, st.accum, bstate,
                                       eng.ids_from_batch(batch))
    assert t2["sparse"] is tables["sparse"] and a2["sparse"] is st.accum["sparse"]
    jtables = {"sparse": jnp.asarray(_table(2))}
    jwss, *_ = jeng.pull_batch(jtables, jeng.init_state(jtables).accum,
                               jeng.init_backend_state(jtables),
                               {k: jnp.asarray(v) for k, v in batch_np.items()})
    for got, want in zip(wss["sparse"], jwss["sparse"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lws, _ = eng.lookup_batch(tables, st.accum, bstate, batch)
    for got, want in zip(wss["sparse"], lws["sparse"]):
        assert torch.equal(got, want)
    before = tables["sparse"].clone()
    grads = {"sparse": torch.ones_like(wss["sparse"].rows)}
    out_t, out_a, _ = eng.push(tables, st.accum, bstate, wss, grads)
    assert out_t["sparse"] is tables["sparse"]            # in place
    touched = torch.zeros(ROWS, dtype=torch.bool)
    touched[wss["sparse"].uids.long()] = True
    assert torch.equal(tables["sparse"][~touched], before[~touched])
    assert not torch.equal(tables["sparse"][touched], before[touched])
    with pytest.raises(TypeError, match="cache_rows"):
        tbe.make_backend("cached")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbe.make_backend("routed")
    with pytest.raises(ValueError, match="unknown placement"):
        tbe.make_backend("nope")
    with pytest.raises(ValueError, match="requires spill_dir"):
        make_store("disk")
