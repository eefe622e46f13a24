"""The port's cache-tier hash map (``repro_torch.kernels.hash_map``) against
the reference's (``repro.kernels.hash_map``), on the CPU.

Everything here is integer, so every check is exact equality:
  - ``hash_bucket``: the reference's bucket for every id (ids up to
    2^31 - 1, H from 8 to 2^20), though the port mixes in int64;
  - ``hash_insert`` / ``hash_rebuild``: the same ``key_tab``, ``slot_tab``
    and ``n_occupied`` for the same insert streams (forced collisions,
    conflicting claims in one round, stale-bucket reuse, random churn, the
    cases of ``tests/test_hash_map.py``);
  - the port's plain probe ``ref.hash_lookup_ref``: the reference's Pallas
    probe (``hash_lookup_pallas(interpret=True)``) and jnp oracle on the
    same maps.
The CUDA probe is held against the plain probe on the card
(``tests/test_torch_gpu.py``), also on the chains that cross its 4-bucket
loads' edges and wrap (``edge_chain_stream``), which the plain probe here
walks as the reference does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hash_map as jhm
from repro.kernels import ref as jref
from repro_torch.kernels import hash_map as hm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from tests.test_torch_gpu import edge_chain_stream

torch.set_num_threads(1)


class Maps:
    """One map in both frameworks, fed the same insert stream."""

    def __init__(self, H):
        self.H = H
        self.j = (jnp.full((H,), jhm.EMPTY, jnp.int32),
                  jnp.zeros((H,), jnp.int32), jnp.zeros((), jnp.int32))
        self.t = (torch.full((H,), hm.EMPTY, dtype=torch.int32),
                  torch.zeros((H,), dtype=torch.int32),
                  torch.zeros((), dtype=torch.int32))

    def insert(self, keys, slots, mask=None):
        keys = np.asarray(keys, np.int32)
        slots = np.asarray(slots, np.int32)
        mask = np.ones(keys.shape, bool) if mask is None else mask
        self.j = jhm.hash_insert(*self.j, jnp.asarray(keys),
                                 jnp.asarray(slots), jnp.asarray(mask))
        self.t = hm.hash_insert(*self.t, torch.from_numpy(keys),
                                torch.from_numpy(slots),
                                torch.from_numpy(mask))
        self.assert_equal()

    def rebuild(self, slot_uid):
        slot_uid = np.asarray(slot_uid, np.int32)
        self.j = jhm.hash_rebuild(jnp.asarray(slot_uid), self.H)
        self.t = hm.hash_rebuild(torch.from_numpy(slot_uid), self.H)
        self.assert_equal()

    def assert_equal(self):
        for got, want in zip(self.t, self.j):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def probe(self, slot_uid, uids):
        """The port's plain probe, equal to the Pallas probe and the jnp
        oracle; returns the slots."""
        slot_uid = np.asarray(slot_uid, np.int32)
        uids = np.asarray(uids, np.int32)
        jargs = (*self.j[:2], jnp.asarray(slot_uid), jnp.asarray(uids))
        want = np.asarray(jhm.hash_lookup_pallas(*jargs, interpret=True))
        np.testing.assert_array_equal(want,
                                      np.asarray(jref.hash_lookup_ref(*jargs)))
        got = tref.hash_lookup_ref(*self.t[:2], torch.from_numpy(slot_uid),
                                   torch.from_numpy(uids)).numpy()
        np.testing.assert_array_equal(got, want)
        return got


@pytest.mark.parametrize("H", [8, 64, 4096, 1 << 20])
def test_hash_bucket_is_the_reference_bucket(H):
    rng = np.random.default_rng(H)
    ids = np.concatenate([
        np.arange(0, 4096), rng.integers(0, 2**31 - 1, 200_000),
        [2**31 - 1, 2**31 - 2, 2**24, 2**16, 2**16 - 1]]).astype(np.int32)
    got = hm.hash_bucket(torch.from_numpy(ids), H)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jhm.hash_bucket(jnp.asarray(ids), H)))


def test_table_size_is_the_reference_size():
    for c in (1, 7, 8, 100, 4096, 262144):
        assert hm.hash_table_size(c) == jhm.hash_table_size(c)
    with pytest.raises(ValueError, match="power of 2"):
        hm.hash_bucket(torch.zeros(3, dtype=torch.int32), 12)


def _colliding(H, n):
    cand = np.arange(0, 200_000, dtype=np.int32)
    buckets = np.asarray(jhm.hash_bucket(jnp.asarray(cand), H))
    ids = cand[buckets == buckets[0]][:n]
    assert len(ids) == n
    return ids


def test_forced_collisions_and_conflicting_claims():
    """Keys with one home bucket, inserted in one batch: they race for the
    same EMPTY buckets round after round (highest position wins)."""
    C = 8
    m = Maps(hm.hash_table_size(C))
    ids = _colliding(m.H, 7)
    m.insert(ids[:6], np.arange(6))
    slot_uid = np.full(C, -1, np.int32)
    slot_uid[:6] = ids[:6]
    np.testing.assert_array_equal(m.probe(slot_uid, ids), list(range(6)) + [-1])


def test_stale_entry_reuse_and_rebuild():
    """An evicted id's entry goes stale (a miss), re-admission reuses its
    bucket in place, and a rebuild drops every stale entry."""
    C = 4
    m = Maps(hm.hash_table_size(C))
    m.insert([10, 20], [0, 1])
    m.insert([30], [0])                                  # 10 evicted
    np.testing.assert_array_equal(m.probe([30, 20, -1, -1], [10, 20, 30]),
                                  [-1, 1, 0])
    m.insert([10], [2])                                  # reuse 10's bucket
    assert int(m.t[2]) == 3
    np.testing.assert_array_equal(m.probe([30, 20, 10, -1], [10, 20, 30]),
                                  [2, 1, 0])
    m.rebuild([30, -1, 10, 55])
    np.testing.assert_array_equal(m.probe([30, -1, 10, 55], [10, 20, 30, 55]),
                                  [2, -1, 0, 3])
    # a masked-out key is not inserted
    m.insert([77, 78], [1, 1], mask=np.array([False, True]))
    np.testing.assert_array_equal(m.probe([30, 78, 10, 55], [77, 78]),
                                  [-1, 1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_churn_matches_reference(seed):
    """Admission/eviction churn with a rebuild every 10 rounds: both maps
    equal after every step, and the probe equals a dense id -> slot
    model."""
    rng = np.random.default_rng(seed)
    C, R = 32, 500
    m = Maps(hm.hash_table_size(C))
    slot_uid = np.full(C, -1, np.int32)
    dense = np.full(R, -1, np.int32)
    for step in range(30):
        ids = rng.choice(R, size=rng.integers(1, 12), replace=False)
        ids = ids[dense[ids] < 0].astype(np.int32)
        if ids.size:
            victims = rng.choice(C, size=ids.size, replace=False)
            for v in victims:
                if slot_uid[v] >= 0:
                    dense[slot_uid[v]] = -1
            slot_uid[victims] = ids
            dense[ids] = victims
            m.insert(ids, victims)
        if step % 10 == 9:
            m.rebuild(slot_uid)
        probe = rng.choice(R, size=64).astype(np.int32)
        np.testing.assert_array_equal(m.probe(slot_uid, probe), dense[probe])


def test_long_chains_and_ids_near_int32_max():
    """A tiny map at load 3/4 (long chains) and ids near 2^31 - 1."""
    rng = np.random.default_rng(5)
    m = Maps(64)
    ids = (2**31 - 1 - rng.choice(10**6, 48, replace=False)).astype(np.int32)
    m.insert(ids, np.arange(48))
    slot_uid = ids.copy()
    slot_uid[::5] = -1                                   # some stale
    got = m.probe(slot_uid, np.concatenate([ids, ids[:8] - 1]))
    assert (got >= 0).sum() == (slot_uid >= 0).sum()


@pytest.mark.parametrize("H,fill", [(64, 0.75), (256, 0.25), (256, 0.75)])
def test_chains_across_group_edges_and_the_wrap(H, fill):
    """Chains that cross aligned 4-bucket edges (the CUDA probe reads a
    group of four buckets a load) and wrap from H - 1 to 0, on maps 1/4 and
    3/4 full, with stale entries and ids never admitted, ids just below
    2^31 - 1: the port's plain probe equals the reference's Pallas probe
    and jnp oracle."""
    C, admissions, probe = edge_chain_stream(H, 29, fill)
    m = Maps(H)
    slot_uid = np.full(C, -1, np.int32)
    for keys, slots in admissions:
        slot_uid[slots] = keys
        m.insert(keys, slots)
    assert int(m.t[2]) == int(fill * H)
    got = m.probe(slot_uid, probe)
    assert (got >= 0).any() and (got < 0).any()
    last = int(hm.hash_bucket(m.t[0][m.t[0] != hm.EMPTY], H).max())
    assert last == H - 1 and int(m.t[0][0]) != hm.EMPTY     # a wrapped chain


def test_cpu_dispatch_runs_the_plain_probe_and_counts_it():
    m = Maps(hm.hash_table_size(8))
    m.insert([3, 9], [0, 5])
    slot_uid = torch.tensor([3, -1, -1, -1, -1, 9, -1, -1], dtype=torch.int32)
    ops.reset_launches()
    got = ops.hash_lookup(*m.t[:2], slot_uid,
                          torch.tensor([9, 3, 4], dtype=torch.int32))
    assert got.tolist() == [5, 0, -1]
    assert ops.launches["hash_lookup_ref"] == 1
    assert ops.launches["hash_lookup"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        hm.hash_lookup_cuda(*m.t[:2], slot_uid,
                            torch.tensor([9], dtype=torch.int32))
