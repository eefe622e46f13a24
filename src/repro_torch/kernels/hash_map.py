"""The cache tier's id -> slot index: a linear-probe hash map on the device.

Counterpart of ``repro/kernels/hash_map.py``.  The map is three tensors of
O(cache_rows) size, kept in the cache tier's ``CacheState``:

  - ``key_tab``    (H,) int32: the id held by each bucket (``EMPTY`` = -1);
  - ``slot_tab``   (H,) int32: the cache slot that id was admitted to;
  - ``n_occupied`` ()  int32: occupied buckets, stale ones included.

An entry ``(k, s)`` is live iff ``slot_uid[s] == k``: eviction overwrites
``slot_uid[s]`` and so kills the evicted id's entry without touching the
map.  Buckets only go from EMPTY to occupied between rebuilds, so a probe
from the home bucket that stops at the key or at an EMPTY bucket is exact,
and ``hash_table_size`` (H >= 4 * cache_rows) with the cache tier's rebuild
bound (occupancy <= 3H/4) keeps an EMPTY bucket on every chain.

Map maintenance (``hash_insert``, ``hash_rebuild``) is plain PyTorch on the
tensors' device, as the reference's is jnp.  The batch probe is the
hand-written CUDA kernel ``csrc/hash_map.cu`` (``hash_lookup_cuda``), held
against ``ref.hash_lookup_ref``; ``ops.hash_lookup`` picks between them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import extension

EMPTY = -1  # the key of a bucket that was never occupied

_M32 = 0xFFFFFFFF
_MURMUR_C1 = 0x85EBCA6B
_MURMUR_C2 = 0xC2B2AE35


def hash_table_size(cache_rows: int) -> int:
    """Bucket count H for a cache of ``cache_rows`` slots: the next power of
    two >= 4 * cache_rows (load <= 0.25 after a rebuild)."""
    n = max(int(cache_rows), 8) * 4
    return 1 << (n - 1).bit_length()


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32): the constant is split
    into 16-bit halves, so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_bucket(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Home bucket per key: the 32-bit murmur3 finalizer of the key's
    uint32 bits, masked to H - 1 (int32), the reference's bucket for every
    id.  PyTorch has no uint32 arithmetic, so the mix runs in int64 with
    ``& 0xFFFFFFFF``."""
    if n_buckets & (n_buckets - 1):
        raise ValueError(f"n_buckets must be a power of 2, got {n_buckets}")
    x = keys.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _MURMUR_C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MURMUR_C2)
    x = x ^ (x >> 16)
    return (x & (n_buckets - 1)).to(torch.int32)


def hash_insert(key_tab, slot_tab, n_occupied, keys, slots, mask):
    """Insert ``keys[i] -> slots[i]`` where ``mask[i]`` (the keys under the
    mask are distinct and not live in the map); returns
    ``(key_tab, slot_tab, n_occupied)``, the tables updated in place.

    Rounds of parallel probing, as the reference: every pending key claims
    the first bucket on its chain that is EMPTY or already holds the key (a
    stale entry of a past residency, reused in place).  Claims on one EMPTY
    bucket go to the highest key position (``scatter_reduce_`` "amax", the
    same answer in any order); the others advance one probe and retry.
    Only the pending keys are carried from round to round; the host reads
    whether any is left once per round.
    """
    H = key_tab.shape[0]
    pos = torch.nonzero(mask).reshape(-1)
    keys, slots = keys[pos], slots[pos]
    base = hash_bucket(keys, H).to(torch.int64)
    off = torch.zeros_like(base)
    n_occ = n_occupied.clone()
    while pos.numel():
        b = (base + off) & (H - 1)
        kb = key_tab[b]
        reuse = kb == keys
        free = kb == EMPTY
        winner = torch.full((H + 1,), -1, dtype=torch.int64,
                            device=key_tab.device)
        winner.scatter_reduce_(0, torch.where(free, b, H), pos, "amax")
        won = reuse | (free & (winner[b] == pos))
        sink = b[won]
        key_tab[sink] = keys[won]
        slot_tab[sink] = slots[won]
        n_occ += (won & free).sum(dtype=torch.int32)
        left = ~won
        if not bool(left.any()):
            break
        pos, keys, slots = pos[left], keys[left], slots[left]
        base, off = base[left], off[left] + 1
    return key_tab, slot_tab, n_occ


def hash_rebuild(slot_uid: torch.Tensor, n_buckets: int):
    """A fresh ``(key_tab, slot_tab, n_occupied)`` holding only the live
    ``(slot_uid[s], s)`` pairs: every stale entry is dropped at once."""
    dev = slot_uid.device
    key_tab = torch.full((n_buckets,), EMPTY, dtype=torch.int32, device=dev)
    slot_tab = torch.zeros((n_buckets,), dtype=torch.int32, device=dev)
    slots = torch.arange(slot_uid.shape[0], dtype=torch.int32, device=dev)
    return hash_insert(key_tab, slot_tab,
                       torch.zeros((), dtype=torch.int32, device=dev),
                       slot_uid, slots, slot_uid >= 0)


def hash_lookup_cuda(key_tab, slot_tab, slot_uid, uids):
    """``slots[i]`` = the live cache slot of ``uids[i]``, or -1: one kernel
    launch on the current stream (``csrc/hash_map.cu``).  The binding makes
    every check of the four tensors and raises ``ValueError``; here only
    the device is tested, so that CPU tensors never reach the extension."""
    if not key_tab.is_cuda:
        raise ValueError(
            f"hash_lookup_cuda takes CUDA tensors, got {key_tab.device}")
    return extension().hash_lookup(key_tab, slot_tab, slot_uid, uids)
