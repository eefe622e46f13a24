"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is false (a
CUDA kernel has no CPU mode).  On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it also runs where JAX is not installed.  The
kernel adds in the plain version's order without fused multiply-adds, so
it is compared for bit equality with the plain version on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# (capacity, dim, nnz, num_bags): every dim class of the kernel, empty bags;
# DIN's 18 (not a multiple of 4: the scalar walk) and two-tower's 256 (the
# top of the bag's range)
SHAPES = [(37, 16, 101, 19), (64, 24, 40, 53), (200, 64, 300, 120),
          (90, 100, 257, 40), (64, 200, 150, 31), (50, 18, 120, 37),
          (40, 256, 90, 23)]


def _case(seed, C, D, nnz, num_bags, weighted=True):
    rng = np.random.default_rng(seed)
    working = rng.standard_normal((C + 1, D)).astype(np.float32)
    working[C] = 0.0
    inv = rng.integers(0, C, nnz).astype(np.int32)
    inv[rng.random(nnz) < 0.1] = C
    used = rng.choice(num_bags, size=max(1, num_bags * 2 // 3), replace=False)
    seg = rng.choice(used, size=nnz).astype(np.int32)
    w = (rng.random(nnz) < 0.9).astype(np.float32) if weighted else None
    return [None if x is None else torch.from_numpy(x)
            for x in (working, inv, seg, w)]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_bag_matches_plain_version(shape, weighted):
    _cuda_or_skip()
    cpu = _case(9, *shape, weighted=weighted)
    dev = [None if x is None else x.cuda() for x in cpu]
    got = tbag.embedding_bag_cuda(*dev, shape[3])
    again = tbag.embedding_bag_cuda(*dev, shape[3])
    torch.cuda.synchronize()
    want = tref.embedding_bag_ref(*cpu, shape[3])
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_cuda_bag_autograd_matches_plain_autograd(combiner):
    _cuda_or_skip()
    working, inv, seg, w = [x.cuda() for x in _case(10, *SHAPES[2])]
    g = torch.randn((SHAPES[2][3], SHAPES[2][1]), device="cuda")
    got = []
    for fn in (ops.embedding_bag_working, tref.embedding_bag_combiner_ref):
        x = working.clone().requires_grad_(True)
        y = w.clone().requires_grad_(True)
        out = fn(x, inv, seg, y, SHAPES[2][3], combiner)
        (out * g).sum().backward()
        got.append((out.detach(), x.grad, y.grad))
    for a, b in zip(*got):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_non_contiguous_input():
    _cuda_or_skip()
    working, inv, seg, w = [x.cuda() for x in _case(11, *SHAPES[2])]
    with pytest.raises(ValueError, match="contiguous"):
        tbag.embedding_bag_cuda(working.t().contiguous().t(), inv, seg, w,
                                SHAPES[2][3])


def _grad_case(seed, C, D, nnz, num_bags):
    """Bag inputs plus a cotangent of the bag's output, on the CPU."""
    working, inv, seg, w = _case(seed, C, D, nnz, num_bags)
    g = torch.from_numpy(np.random.default_rng(seed + 100).standard_normal(
        (num_bags, D)).astype(np.float32))
    return g, working, inv, seg, w


def _rows_case(seed, D, counts, num_bags, weighted, bad_seg):
    """Backward inputs on the CPU whose working row r holds ``counts[r]``
    entries (in shuffled positions); with ``bad_seg``, some segments lie
    outside [0, num_bags)."""
    rng = np.random.default_rng(seed)
    inv = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    inv = inv[rng.permutation(len(inv))]
    seg = rng.integers(0, num_bags, len(inv)).astype(np.int32)
    if bad_seg:
        seg[rng.random(len(inv)) < 0.05] = -1
        seg[rng.random(len(inv)) < 0.05] = num_bags + 3
    w = (rng.standard_normal(len(inv)).astype(np.float32) if weighted
         else None)
    g = rng.standard_normal((num_bags, D)).astype(np.float32)
    working = rng.standard_normal((len(counts), D)).astype(np.float32)
    return [None if x is None else torch.from_numpy(x)
            for x in (g, working, inv, seg, w)]


T, V = tbag.LONG_ROW, tbag.VERY_LONG
# the long-row thresholds' edges (T - 1, T, T + 1 entries; V, V + 1), one
# row that holds every entry, phase 1's hot row of 4130 entries beside
# Zipf-like others, and 300 long rows (more than the long rows' kernel has
# blocks) beside two very long ones; each at every width class
ROW_LAYOUTS = {"edges": [T - 1, T, T + 1, 3, 0, 1, 40, V, V + 1],
               "one_row": [0, 3000, 0, 0],
               "hot": [4130, 2017, 1310, 700, 300, 130, 128, 33, 5, 1, 0],
               "many_long": ([T + 1 + (i * 7) % 272 for i in range(300)]
                             + [V + 1, 2 * V] + [5, 1, 0] * 20)}


def _grid_layout(extra):
    """(dim, counts) whose very long rows' (row, 8 columns) items number
    the long rows' kernel's grid (one block an SM) plus ``extra``, beside
    long rows of 129 to 1024 entries and short ones: at extra 0 the first
    items hand every block a very long one."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slices = max(d for d in range(1, 13) if sms % d == 0)
    very = sms // slices + extra
    return 8 * slices, ([V + 1 + i for i in range(very)]
                        + [T + 1, 500, V, 700, 200, 129] + [3, 0, 60] * 5)


def _backward_case(spec, weighted):
    """Random shapes (``SHAPES``, with mask weights) or a row layout
    (``(dim, layout)``, or ``("grid", extra)`` for ``_grid_layout``; normal
    weights, some segments out of range)."""
    if len(spec) == 4:
        g, working, inv, seg, w = _grad_case(12, *spec)
        return g, working, inv, seg, w if weighted else None
    if spec[0] == "grid":
        D, counts = _grid_layout(spec[1])
    else:
        D, counts = spec[0], ROW_LAYOUTS[spec[1]]
    return _rows_case(D, D, counts, 2000, weighted, True)


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("spec", SHAPES + [
    (D, layout) for D in (16, 18, 24, 64, 100, 200, 256)
    for layout in ("edges", "one_row", "hot", "many_long")] + [
    ("grid", extra) for extra in (-1, 0, 1)])
def test_cuda_bag_backward_matches_plain_vjp(spec, weighted):
    """Working-row grads bit-equal to the CPU plain vjp (the kernel adds in
    its order without fused multiply-adds), on short rows, long rows and
    both sides of the long-row threshold, hundreds of long rows, and very
    long rows that fill the long rows' grid, at every width class; weight
    grads within rtol = atol = 1e-5 (the plain version sums each dot
    product in another order); two runs bit-equal."""
    _cuda_or_skip()
    cpu = _backward_case(spec, weighted)
    dev = [None if x is None else x.cuda() for x in cpu]
    need_w = weighted
    got = tbag.embedding_bag_backward_cuda(*dev, need_working=True,
                                           need_weights=need_w)
    again = tbag.embedding_bag_backward_cuda(*dev, need_working=True,
                                             need_weights=need_w)
    torch.cuda.synchronize()
    want = tref.embedding_bag_backward_ref(*cpu, need_working=True,
                                           need_weights=need_w)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[0], again[0])
    if need_w:
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(got[1], again[1])


def plain_streams(keys, num_rows, index, weights, long_row=T):
    """The backward's index streams on CPU tensors by a stable sort, what
    ``tbag.backward_streams`` builds on the card: ``(index_sorted,
    weights_sorted, offsets, keys_sorted, row_lists)``, a key outside [0,
    num_rows) read as ``num_rows`` (last), with the row lists of rows of
    more than ``long_row`` entries (the card's is ``T``), each list
    ascending and zeros in the rest of its room."""
    keys = torch.where((keys >= 0) & (keys < num_rows), keys,
                       torch.full_like(keys, num_rows))
    keys_sorted, order = torch.sort(keys, stable=True)
    bounds = torch.arange(num_rows + 1, dtype=keys.dtype)
    offsets = torch.searchsorted(keys_sorted, bounds)
    counts = offsets[1:] - offsets[:-1]
    very = torch.nonzero(counts > V).flatten()
    other = torch.nonzero((counts > long_row) & (counts <= V)).flatten()
    short = torch.nonzero((counts > 0) & (counts <= long_row)).flatten()
    nnz = keys.numel()
    room = nnz // (long_row + 1)
    rows = torch.zeros(4 + room + nnz, dtype=torch.int32)
    rows[:4] = torch.tensor([very.numel(), other.numel(), long_row,
                             short.numel()])
    rows[4:4 + very.numel()] = very
    rows[4 + room - other.numel():4 + room] = other.flip(0)
    rows[4 + room:4 + room + short.numel()] = short
    w = None if weights is None else weights.index_select(0, order)
    return (index.index_select(0, order), w, offsets, keys_sorted, rows)


def _list_parts(row_lists, nnz):
    """The row lists' counts and threshold, and their three parts as sorted
    lists (the card fills each part in no fixed order)."""
    lst = row_lists.cpu().tolist()
    n_very, n_long, n_short = lst[0], lst[1], lst[3]
    room = len(lst) - 4 - nnz
    return (lst[:4], sorted(lst[4:4 + n_very]),
            sorted(lst[4 + room - n_long:4 + room]),
            sorted(lst[4 + room:4 + room + n_short]))


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("layout", sorted(ROW_LAYOUTS))
def test_cuda_bag_backward_streams(layout, weighted):
    """The CUDA index streams equal their plain version on the CPU (a
    stable order, out-of-range rows last, a few or more than ``T`` of
    them, the same row lists)."""
    _cuda_or_skip()
    g, working, inv, seg, w = _rows_case(3, 64, ROW_LAYOUTS[layout], 500,
                                         weighted, True)
    rows = working.shape[0]
    bad = inv.clone()
    bad[:5] = -2                                   # rows outside the set
    bad[5:9] = rows
    many_bad = inv.clone()
    many_bad[::7] = -1                             # a long sentinel group
    for keys in (inv, bad, many_bad):
        got = tbag.backward_streams(
            g.cuda(), keys.cuda(), seg.cuda(),
            None if w is None else w.cuda(), rows)
        want = plain_streams(keys, rows, seg, w)
        for a, b in zip(got[:4], want[:4]):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
        assert got[4].shape == want[4].shape
        assert _list_parts(got[4], len(keys)) == _list_parts(want[4],
                                                             len(keys))


# bags of 0, 1, 31, 32, 33 and 129 entries (both sides of a half-warp and a
# warp of pairs, and of the long-group threshold T) beside short ones
BAG_SIZES = [0, 1, 31, 32, 33, 129, 2, 0, 3, 5, 1]


def _bags_case(seed, D, sizes, weighted, bad_seg, C=300):
    """Forward inputs on the CPU whose bag b holds ``sizes[b]`` entries (in
    shuffled positions); with ``bad_seg``, entries with ``seg`` negative
    and at or above the bag count, which fall in no bag."""
    rng = np.random.default_rng(seed)
    seg = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    if bad_seg:
        seg = np.concatenate([seg, [-1, -7, len(sizes), len(sizes) + 40]
                              * 3]).astype(np.int32)
    seg = seg[rng.permutation(len(seg))]
    inv = rng.integers(0, C + 1, len(seg)).astype(np.int32)
    working = rng.standard_normal((C + 1, D)).astype(np.float32)
    working[C] = 0.0
    w = rng.standard_normal(len(seg)).astype(np.float32) if weighted else None
    return [None if x is None else torch.from_numpy(x)
            for x in (working, inv, seg, w)]


@pytest.mark.gpu
@pytest.mark.parametrize("bad_seg", [False, True])
@pytest.mark.parametrize("weighted", [True, False])
def test_cuda_bag_forward_streams(weighted, bad_seg):
    """The forward's CUDA index streams equal their plain versions exactly:
    a stable sort by seg (``plain_streams``, out-of-range bags last) and,
    for the bags, ``csr_from_segments``."""
    _cuda_or_skip()
    working, inv, seg, w = _bags_case(4, 64, BAG_SIZES, weighted, bad_seg)
    nb = len(BAG_SIZES)
    got = tbag.forward_streams(working.cuda(), inv.cuda(), seg.cuda(),
                               None if w is None else w.cuda(), nb)
    want = plain_streams(seg, nb, inv, w)
    for a, b in zip(got, want[:4]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    order, offsets = tbag.csr_from_segments(seg, nb)
    lo, hi = int(offsets[0]), int(offsets[-1])
    assert torch.equal(got[2].cpu(), offsets - lo)
    assert torch.equal(got[0][:hi - lo].cpu(), inv[order[lo:hi]])
    if w is not None:
        assert torch.equal(got[1][:hi - lo].cpu(), w[order[lo:hi]])
    assert int(offsets[1:].sub(offsets[:-1]).max()) == 129


def _unaligned(x):
    """A contiguous copy of ``x`` whose data lies 4 bytes off a 16-byte
    edge (the kernels then read a float or a bucket a load)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("D", [3, 16, 24, 37, 64, 100, 128, 130, 200, 256])
def test_cuda_bag_sizes_match_plain_version(D, weighted):
    """Bags of 0 to 129 entries and out-of-range segments at every width
    class of the walk (float4 loads at D a multiple of 4, else a float a
    load; also a working set 4 bytes off a 16-byte edge): bit-equal to the
    CPU plain version, two runs bit-equal, and the walk alone on the
    streams equal to the wrapper."""
    _cuda_or_skip()
    cpu = _bags_case(5, D, BAG_SIZES * 3, weighted, True)
    nb = len(BAG_SIZES) * 3
    dev = [None if x is None else x.cuda() for x in cpu]
    want = tref.embedding_bag_ref(*cpu, nb)
    got = tbag.embedding_bag_cuda(*dev, nb)
    again = tbag.embedding_bag_cuda(*dev, nb)
    off = tbag.embedding_bag_cuda(_unaligned(dev[0]), *dev[1:], nb)
    walked = tbag.walk(dev[0], *tbag.forward_streams(*dev, nb)[:3])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again) and torch.equal(off, got)
    assert torch.equal(walked, got)


def _push_case(seed, rows, D, n_ids, capacity):
    """A table, its accumulator, and one working set's (uids, grads) laid
    out by pull_working_set (pads at the end, or none on overflow)."""
    from repro_torch.core.embedding_backend import pull_working_set

    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((rows, D)).astype(
        np.float32))
    accum = torch.from_numpy(rng.random((rows, D)).astype(np.float32) + 0.01)
    ids = torch.from_numpy(rng.integers(0, rows, n_ids).astype(np.int32))
    uids, inv = pull_working_set(ids, capacity)
    grads = torch.from_numpy(rng.standard_normal((capacity, D)).astype(
        np.float32))
    n_real = int(torch.unique(ids).numel())
    grads[n_real:] = 0.0           # pads get no gradient
    return table, accum, uids, grads


@pytest.mark.gpu
@pytest.mark.parametrize("rows,D,n_ids,capacity", [
    (5000, 64, 900, 1024),       # pads
    (3000, 16, 600, 512),        # odd width, pads
    (4000, 100, 700, 256),       # overflow: no pads
    (3000, 18, 600, 512),        # DIN's width: the scalar branch, pads
    (2000, 256, 500, 512),       # two-tower's width, pads
])
def test_cuda_push_matches_plain_version(rows, D, n_ids, capacity):
    """The push kernel, which does the row math itself, against the plain
    version (adagrad_row_updates, then index_add_): the same bits, with
    untouched rows unchanged and two runs equal."""
    _cuda_or_skip()
    from repro_torch.kernels.sparse_adagrad import (
        adagrad_row_updates,
        sparse_adagrad_apply_cuda,
    )

    table, accum, uids, grads = _push_case(13, rows, D, n_ids, capacity)
    delta, g2 = adagrad_row_updates(accum[uids.long()], grads, table.dtype,
                                    lr=0.5, eps=1e-10)
    want = tref.sparse_adagrad_apply_ref(table.clone(), accum.clone(), uids,
                                         delta, g2)
    outs = []
    for _ in range(2):
        t, a = table.cuda(), accum.cuda()
        got = sparse_adagrad_apply_cuda(t, a, uids.cuda(), grads.cuda(),
                                        lr=0.5, eps=1e-10)
        torch.cuda.synchronize()
        assert got[0] is t and got[1] is a          # in place
        outs.append((t.cpu(), a.cpu()))
    for t, a in outs:
        assert torch.equal(t, want[0]) and torch.equal(a, want[1])
    touched = torch.zeros(rows, dtype=torch.bool)
    touched[uids.long()] = True
    assert torch.equal(outs[0][0][~touched], table[~touched])


@pytest.mark.gpu
def test_cuda_push_addresses_rows_beyond_int32_offsets():
    """uid * dim above 2^31: the kernel's table offsets are 64-bit.  The
    three rows are held against the plain version on copies of them."""
    _cuda_or_skip()
    from repro_torch.kernels.sparse_adagrad import sparse_adagrad_apply_cuda

    D = 64
    rows = (1 << 31) // D + 4096                 # 8.6 GB per tensor
    table = torch.zeros((rows, D), device="cuda")
    accum = torch.ones((rows, D), device="cuda")
    uids = torch.tensor([7, (1 << 31) // D + 3, rows - 1], dtype=torch.int32,
                        device="cuda")
    grads = torch.arange(3 * D, dtype=torch.float32,
                         device="cuda").reshape(3, D) / 7
    want = tref.sparse_adagrad_ref(table[uids.long()].clone(),
                                   accum[uids.long()].clone(), grads, 0.5,
                                   1e-10)
    sparse_adagrad_apply_cuda(table, accum, uids, grads, lr=0.5, eps=1e-10)
    torch.cuda.synchronize()
    for i, u in enumerate(uids.tolist()):
        assert torch.equal(table[u], want[0][i])
        assert torch.equal(accum[u], want[1][i])
    assert int(torch.count_nonzero(table)) == int(
        torch.count_nonzero(want[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("stream", ["uids", "slots"])
@pytest.mark.parametrize("case", ["pads", "overflow", "unaligned"])
@pytest.mark.parametrize("D", [3, 16, 18, 64, 100, 256])
def test_cuda_fused_push_equals_row_math_and_index_add(D, case, stream):
    """Both pushes (the table's by uids, the cache's by slots) do the row
    math in the kernel: bit-equal to ``adagrad_row_updates`` on the
    gathered accumulator rows followed by ``index_add_``, on a batch with
    pads, an overflowed batch (no pads) and unaligned tensors (the scalar
    path at every dim); the pads' gradient rows, which hold NaN here, are
    never read; two runs equal."""
    _cuda_or_skip()
    from repro_torch.kernels.sparse_adagrad import (
        adagrad_row_updates,
        sparse_adagrad_apply_cuda,
        sparse_adagrad_cached_apply_cuda,
    )

    capacity = 256 if case == "overflow" else 1024
    table, accum, uids, grads = _push_case(29 + D, 3000, D, 700, capacity)
    n_real = 1 + int((uids[1:] > uids[:-1]).sum())
    assert (n_real < capacity) == (case != "overflow")
    if stream == "uids":
        idx = uids
    else:                                   # a permutation, pads share [0]
        perm = torch.from_numpy(np.random.default_rng(D).permutation(
            table.shape[0])[:n_real].astype(np.int32))
        idx = torch.cat([perm, perm[:1].expand(capacity - n_real)])
    delta, g2 = adagrad_row_updates(accum[idx.long()], grads, table.dtype,
                                    lr=0.5, eps=1e-10)
    want = tref.sparse_adagrad_apply_ref(table.clone(), accum.clone(), idx,
                                         delta, g2)
    grads[n_real:] = float("nan")           # a pad's row is never read
    runs = []
    for _ in range(2):
        t, a, g = table.cuda(), accum.cuda(), grads.cuda()
        if case == "unaligned":
            t, a, g = _unaligned(t), _unaligned(a), _unaligned(g)
        if stream == "uids":
            out = sparse_adagrad_apply_cuda(t, a, uids.cuda(), g, lr=0.5,
                                            eps=1e-10)
        else:
            out = sparse_adagrad_cached_apply_cuda(t, a, idx.cuda(),
                                                   uids.cuda(), g, lr=0.5,
                                                   eps=1e-10)
        torch.cuda.synchronize()
        assert out[0] is t and out[1] is a
        runs.append((t.cpu(), a.cpu()))
    for t, a in runs:
        assert torch.equal(t, want[0]) and torch.equal(a, want[1])


# ------------------------------------------------- the cache tier's kernels
def _cache_map(seed, C, n_ids, id_hi, H=None):
    """A hash map over a cache of C slots after two rounds of admissions
    (the second evicts some of the first, so stale entries stand in the
    map), built by the port's plain map maintenance on the CPU; probe ids
    that hit, miss and hit stale entries.  ``H`` smaller than
    ``hash_table_size(C)`` gives long chains."""
    from repro_torch.kernels import hash_map as hm

    rng = np.random.default_rng(seed)
    H = H or hm.hash_table_size(C)
    key_tab = torch.full((H,), hm.EMPTY, dtype=torch.int32)
    slot_tab = torch.zeros((H,), dtype=torch.int32)
    n_occ = torch.zeros((), dtype=torch.int32)
    slot_uid = torch.full((C,), -1, dtype=torch.int32)
    ids = rng.choice(id_hi, size=n_ids, replace=False).astype(np.int32)
    first, second = ids[:C], ids[C:C + C // 2]
    for batch, slots in ((first, np.arange(C)),
                         (second, rng.choice(C, size=second.size,
                                             replace=False))):
        slots = torch.from_numpy(slots.astype(np.int32))
        batch = torch.from_numpy(batch)
        slot_uid[slots.long()] = batch
        key_tab, slot_tab, n_occ = hm.hash_insert(
            key_tab, slot_tab, n_occ, batch, slots,
            torch.ones(batch.shape, dtype=torch.bool))
    probe = torch.from_numpy(rng.choice(ids, size=2 * n_ids).astype(
        np.int32))
    return key_tab, slot_tab, slot_uid, probe


@pytest.mark.gpu
@pytest.mark.parametrize("C,n_ids,id_hi,H", [
    (512, 900, 100_000, None),                 # the slice's load factor
    (32, 60, 1 << 20, 64),                     # tiny H: long chains
    (256, 400, 2**31 - 1, None),               # ids up to 2^31 - 2
])
def test_cuda_hash_probe_matches_plain_version(C, n_ids, id_hi, H):
    _cuda_or_skip()
    from repro_torch.kernels.hash_map import hash_lookup_cuda

    key_tab, slot_tab, slot_uid, probe = _cache_map(17, C, n_ids, id_hi, H)
    want = tref.hash_lookup_ref(key_tab, slot_tab, slot_uid, probe)
    dev = [t.cuda() for t in (key_tab, slot_tab, slot_uid, probe)]
    got = hash_lookup_cuda(*dev)
    again = hash_lookup_cuda(*dev)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    assert (want >= 0).any() and (want < 0).any()


def edge_chain_stream(H, seed, fill, id_hi=2**31 - 1):
    """An insert stream for a map of H buckets whose chains cross aligned
    4-bucket edges and wrap from H - 1 to 0: runs of five ids with one home
    bucket at H - 2, H - 1, and at 4k + 2 and 4k + 3 for a few k, then
    random ids, ``fill * H`` in all, drawn just below ``id_hi``.  Returns
    ``(C, [(keys, slots), (keys, slots)], probe)`` (numpy int32): the first
    admission fills C slots, the second evicts a third of them (their
    entries go stale); ``probe`` holds every id once, each run's ids
    twice, and ids never admitted whose home is a run's."""
    from repro_torch.kernels import hash_map as hm

    rng = np.random.default_rng(seed)
    cand = (id_hi - 1 - rng.choice(8_000_000, 2_000_000, replace=False)
            ).astype(np.int32)
    home = hm.hash_bucket(torch.from_numpy(cand), H).numpy()
    homes = [H - 2, H - 1] + [4 * int(k) + r
                              for k in rng.choice(H // 4 - 1, 3, replace=False)
                              for r in (2, 3)]
    runs = np.concatenate([cand[home == h][:5] for h in homes])
    strangers = np.concatenate([cand[home == h][5:7] for h in homes])
    rest = np.setdiff1d(cand, np.concatenate([runs, strangers]))
    keys = np.concatenate([runs, rng.choice(rest, int(fill * H) - len(runs),
                                            replace=False)])
    keys = keys[rng.permutation(len(keys))].astype(np.int32)
    C = len(keys) * 3 // 4
    first, second = keys[:C], keys[C:]
    evict = rng.choice(C, len(second), replace=False).astype(np.int32)
    probe = np.concatenate([keys, runs, strangers]).astype(np.int32)
    return C, [(first, np.arange(C, dtype=np.int32)), (second, evict)], \
        probe[rng.permutation(len(probe))]


def _edge_map(H, seed, fill):
    """``edge_chain_stream``'s map, built by the port's plain map
    maintenance on the CPU: ``(key_tab, slot_tab, slot_uid, probe)``."""
    from repro_torch.kernels import hash_map as hm

    C, admissions, probe = edge_chain_stream(H, seed, fill)
    key_tab = torch.full((H,), hm.EMPTY, dtype=torch.int32)
    slot_tab = torch.zeros((H,), dtype=torch.int32)
    n_occ = torch.zeros((), dtype=torch.int32)
    slot_uid = torch.full((C,), -1, dtype=torch.int32)
    for keys, slots in admissions:
        keys, slots = torch.from_numpy(keys), torch.from_numpy(slots)
        slot_uid[slots.long()] = keys
        key_tab, slot_tab, n_occ = hm.hash_insert(
            key_tab, slot_tab, n_occ, keys, slots,
            torch.ones(keys.shape, dtype=torch.bool))
    assert int(n_occ) == int(fill * H)
    return key_tab, slot_tab, slot_uid, torch.from_numpy(probe)


@pytest.mark.gpu
@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("H,fill", [(64, 0.75), (4096, 0.25), (4096, 0.75),
                                    (1 << 16, 0.75)])
def test_cuda_hash_probe_crosses_edges_and_wraps(H, fill, unaligned):
    """Chains that cross aligned 4-bucket edges and wrap from H - 1 to 0,
    on maps 1/4 and 3/4 full, ids just below 2^31 - 1, stale entries and
    ids never admitted: bit-equal to the plain version, two runs
    bit-equal; tables 4 bytes off a 16-byte edge take the bucket-a-load
    path and give the same bits."""
    _cuda_or_skip()
    from repro_torch.kernels.hash_map import hash_lookup_cuda

    key_tab, slot_tab, slot_uid, probe = _edge_map(H, 23, fill)
    want = tref.hash_lookup_ref(key_tab, slot_tab, slot_uid, probe)
    dev = [t.cuda() for t in (key_tab, slot_tab, slot_uid, probe)]
    if unaligned:
        dev[:2] = [_unaligned(t) for t in dev[:2]]
    got = hash_lookup_cuda(*dev)
    again = hash_lookup_cuda(*dev)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    assert (want >= 0).any() and (want < 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 2, 4])
def test_cuda_hash_probe_on_tiny_and_full_maps(H):
    """Maps of 1, 2 and 4 buckets, full (no EMPTY bucket: every chain stops
    after H buckets) and empty."""
    _cuda_or_skip()
    from repro_torch.kernels import hash_map as hm
    from repro_torch.kernels.hash_map import hash_lookup_cuda

    ids = torch.arange(5, 5 + H, dtype=torch.int32)
    key_tab, slot_tab, n_occ = hm.hash_rebuild(ids, H)
    assert int(n_occ) == H
    probe = torch.arange(0, 5 + 2 * H, dtype=torch.int32)
    for kt in (key_tab, torch.full((H,), hm.EMPTY, dtype=torch.int32)):
        want = tref.hash_lookup_ref(kt, slot_tab, ids, probe)
        got = hash_lookup_cuda(kt.cuda(), slot_tab.cuda(), ids.cuda(),
                               probe.cuda())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("C,D,cap", [(300, 64, 1000), (77, 16, 50),
                                     (129, 100, 257), (40, 3, 33),
                                     (60, 18, 70), (40, 256, 33)])
def test_cuda_cached_gather_matches_plain_version(C, D, cap):
    _cuda_or_skip()
    from repro_torch.kernels.sparse_adagrad import gather_rows_cached_cuda

    rng = np.random.default_rng(19)
    rows = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, C, cap).astype(np.int32))
    got = gather_rows_cached_cuda(rows.cuda(), slots.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tref.gather_rows_cached_ref(rows, slots))


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("C,D,cap", [(300, 64, 1000), (77, 16, 50),
                                     (129, 100, 257), (40, 3, 33),
                                     (50, 64, 1), (50, 64, 0)])
def test_cuda_cached_gather_with_its_drop_row(C, D, cap, aligned):
    """``drop_row=True``: the rows, then one zero row, bit-equal to
    ``_with_drop_row(index_select)`` (the parent's gather + cat) and to the
    plain version, with 16-byte aligned and unaligned tensors; two runs
    equal.  Slots outside [0, C) give zero rows."""
    _cuda_or_skip()
    from repro_torch.core.embedding_backend import _with_drop_row
    from repro_torch.kernels.sparse_adagrad import gather_rows_cached_cuda

    rng = np.random.default_rng(C + cap)
    rows = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, C, cap).astype(np.int32))
    want = _with_drop_row(rows.index_select(0, slots.long()))
    assert torch.equal(want, tref.gather_rows_cached_ref(rows, slots,
                                                         drop_row=True))
    r, sl = rows.cuda(), slots.cuda()
    if not aligned:
        r, sl = _unaligned(r), _unaligned(sl)
    got = gather_rows_cached_cuda(r, sl, drop_row=True)
    again = ops.gather_rows_cached(r, sl, drop_row=True)
    torch.cuda.synchronize()
    assert got.shape == (cap + 1, D)
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    bad = slots.clone()
    bad[::7] = -1
    bad[1::5] = C
    out = gather_rows_cached_cuda(r, _unaligned(bad.cuda()) if not aligned
                                  else bad.cuda(), drop_row=True).cpu()
    ok = (bad >= 0) & (bad < C)
    assert torch.equal(out[:cap][ok], want[:cap][ok])
    assert not out[:cap][~ok].any() and not out[cap].any()


@pytest.mark.gpu
@pytest.mark.parametrize("C,D,n_ids,capacity", [
    (2048, 64, 900, 1024),       # pads
    (700, 16, 600, 512),         # odd width, pads
    (400, 100, 700, 256),        # overflow: no pads
    (700, 18, 600, 512),         # DIN's width, pads
])
def test_cuda_cached_push_matches_plain_version(C, D, n_ids, capacity):
    """The cached push at slots that are a permutation of the cache (not
    ascending), pads sharing the first id's slot: bit-equal to the plain
    index_add_, untouched slots unchanged, two runs equal."""
    _cuda_or_skip()
    from repro_torch.core.embedding_backend import pull_working_set
    from repro_torch.kernels.sparse_adagrad import (
        adagrad_row_updates,
        sparse_adagrad_cached_apply_cuda,
    )

    rng = np.random.default_rng(23)
    rows = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32))
    accum = torch.from_numpy((rng.random((C, D)) + 0.01).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50_000, n_ids).astype(np.int32))
    uids, _ = pull_working_set(ids, capacity)
    n_real = min(int(torch.unique(ids).numel()), capacity)
    perm = torch.from_numpy(rng.permutation(C)[:n_real].astype(np.int32))
    slots = torch.cat([perm, perm[:1].expand(capacity - n_real)])
    grads = torch.from_numpy(rng.standard_normal((capacity, D)).astype(
        np.float32))
    grads[n_real:] = 0.0
    delta, g2 = adagrad_row_updates(accum[slots.long()], grads, rows.dtype,
                                    lr=0.5, eps=1e-10)
    want = tref.sparse_adagrad_apply_ref(rows.clone(), accum.clone(), slots,
                                         delta, g2)
    outs = []
    for _ in range(2):
        r, a = rows.cuda(), accum.cuda()
        got = sparse_adagrad_cached_apply_cuda(r, a, slots.cuda(),
                                               uids.cuda(), grads.cuda(),
                                               lr=0.5, eps=1e-10)
        torch.cuda.synchronize()
        assert got[0] is r and got[1] is a
        outs.append((r.cpu(), a.cpu()))
    for r, a in outs:
        assert torch.equal(r, want[0]) and torch.equal(a, want[1])
    touched = torch.zeros(C, dtype=torch.bool)
    touched[slots.long()] = True
    assert torch.equal(outs[0][0][~touched], rows[~touched])


@pytest.mark.gpu
def test_cuda_cached_dispatch_counts_the_kernels():
    """ops on CUDA tensors run the three kernels and count them."""
    _cuda_or_skip()
    key_tab, slot_tab, slot_uid, probe = _cache_map(29, 64, 100, 5000)
    dev = [t.cuda() for t in (key_tab, slot_tab, slot_uid, probe)]
    ops.reset_launches()
    slots = ops.hash_lookup(*dev)
    safe = torch.where(slots >= 0, slots, 0)
    rows = torch.randn((64, 8), device="cuda")
    accum = torch.ones((64, 8), device="cuda")
    ops.gather_rows_cached(rows, safe)
    uniq = torch.unique(safe)
    with pytest.raises(ValueError, match="uids"):
        ops.sparse_adagrad_cached_apply(rows, accum, uniq.to(torch.int32),
                                        torch.ones((uniq.numel(), 8),
                                                   device="cuda"),
                                        lr=0.1, eps=1e-10)
    ops.sparse_adagrad_cached_apply(
        rows, accum, uniq.to(torch.int32),
        torch.ones((uniq.numel(), 8), device="cuda"), lr=0.1, eps=1e-10,
        uids=uniq.to(torch.int32))
    torch.cuda.synchronize()
    assert ops.launches["hash_lookup"] == 1
    assert ops.launches["gather_rows_cached"] == 1   # none inside the push
    assert ops.launches["sparse_adagrad_cached_apply"] == 1
    assert all(v == 0 for k, v in ops.launches.items() if k.endswith("_ref"))


@pytest.mark.gpu
def test_cuda_cached_backend_matches_the_cpu():
    """The cached placement with its cache on the card and the table in
    host memory (pinned staging, uploads and spills), against the same
    backend on the CPU: working sets, lookups, the cache state and the host
    table bit-equal over pulls with evictions, spills and rebuilds."""
    _cuda_or_skip()
    from repro_torch.core.cache_tier import CachedBackend
    from repro_torch.core.sparse_optim import SparseAdagrad, SparseAdagradConfig

    rng = np.random.default_rng(31)
    rows, dim, cap, C = 50_000, 64, 2048, 3000
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    opt = SparseAdagrad(SparseAdagradConfig(lr=0.5))
    runs = []
    for device in ("cuda", "cpu"):
        cb = CachedBackend(cache_rows=C, decay=0.9, device=device)
        t = cb.prepare(torch.from_numpy(table.copy()).to(device))
        a = torch.full((rows, dim), 0.01)
        s = cb.init_state(t)
        got = []
        gen = np.random.default_rng(7)
        for _ in range(12):
            ids = torch.from_numpy(((gen.zipf(1.2, 6000) - 1) % rows).astype(
                np.int32)).to(device)
            ws, t, a, s = cb.pull(t, a, s, ids, cap)
            g = torch.from_numpy(gen.standard_normal((cap + 1, dim)).astype(
                np.float32)).to(device)
            g[1 + int((ws.uids[1:] > ws.uids[:-1]).sum()):cap] = 0.0
            t, a, s = cb.push(t, a, s, ws, g, opt)
            lws, aux = cb.lookup(t, a, s, ids.flip(0), cap)
            got.append([x.cpu() for x in (*ws, *lws)]
                       + [aux["serve_misses"].cpu()])
        runs.append((got, [x.cpu() for x in s], t, a))
    (g0, s0, t0, a0), (g1, s1, t1, a1) = runs
    for x, y in zip(g0, g1):
        assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert all(torch.equal(p, q) for p, q in zip(s0, s1))
    assert torch.equal(t0, t1) and torch.equal(a0, a1)
    assert float(s1[-1]) > 0 and float(s1[-3]) >= 1   # spills, rebuilds


# ------------------------------------------- the local Adam step (kernel 6)
def _adam_leaves(seed, sizes, device):
    """Leaves of a podded tree (params, grads, m, v_local, v_hat) with
    positive second moments."""
    gen = torch.Generator().manual_seed(seed)

    def draw(scale=1.0, positive=False):
        out = []
        for n in sizes:
            x = torch.randn((n,), generator=gen) * scale
            out.append((x.abs() + 1e-3 if positive else x).to(device))
        return out

    return (draw(0.3), draw(0.01), draw(0.01), draw(1e-4, True),
            draw(1e-4, True))


def _adam_kwargs(t, device, warmup, bias, wd, lr_tensor, k=20):
    tt = torch.tensor(t, dtype=torch.int32, device=device)
    lr = (torch.tensor(1e-3, dtype=torch.float32, device=device)
          if lr_tensor else 1e-3)
    mhat = vhat = None
    if bias:
        tf = tt.to(torch.float32)
        mhat = 1.0 / (1.0 - 0.9 ** tf)
        vhat = 1.0 / (1.0 - 0.999 ** tf)
    return dict(t=tt, lr=lr, b1=0.9 if bias else 0.0, b2=0.999, k=k,
                local_v_warmup=warmup, mhat_s=mhat, vhat_s=vhat,
                weight_decay=wd)


@pytest.mark.gpu
@pytest.mark.parametrize("lr_tensor", [False, True])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("warmup,t", [(True, 3), (True, 25), (False, 3)])
def test_cuda_fused_adam_matches_plain_version(warmup, t, bias, wd,
                                               lr_tensor):
    """Kernel 6 against its plain version on the card, bit for bit, in
    every branch: warm-up before and after the first merge and off, bias
    correction, weight decay, lr as a float and as a 0-dim tensor; odd
    leaf sizes; two runs bit-equal."""
    _cuda_or_skip()
    from repro_torch.kernels.fused_adam import fused_adam_cuda

    sizes = [4096, 1, 1310720, 513, 131071, 7]
    leaves = _adam_leaves(3, sizes, "cuda")
    kw = _adam_kwargs(t, "cuda", warmup, bias, wd, lr_tensor)
    want = [[x.clone() for x in grp] for grp in leaves]
    tref.fused_adam_ref(*want, **kw)
    runs = []
    for _ in range(2):
        got = [[x.clone() for x in grp] for grp in leaves]
        out = fused_adam_cuda(*got, **kw)
        torch.cuda.synchronize()
        assert out[0] is got[0] and out[1] is got[2] and out[2] is got[3]
        runs.append(got)
    for got in runs:
        for i in (0, 2, 3):                     # params, m, v_local
            for a, b in zip(got[i], want[i]):
                assert torch.equal(a, b)
        for i in (1, 4):                        # grads and v_hat untouched
            for a, b in zip(got[i], leaves[i]):
                assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_fused_adam_many_leaves_and_table_reuse():
    """More than 32 leaves (two launches in one call), a table kept across
    steps and rebuilt when a leaf's storage changes; counted once per
    call by ops."""
    _cuda_or_skip()
    from repro_torch.kernels.fused_adam import AdamTable

    sizes = [int(x) for x in np.random.default_rng(5).integers(1, 3000, 40)]
    leaves = _adam_leaves(4, sizes, "cuda")
    want = [[x.clone() for x in grp] for grp in leaves]
    got = [[x.clone() for x in grp] for grp in leaves]
    table = AdamTable()
    ops.reset_launches()
    for t in (1, 2, 3):
        kw = _adam_kwargs(t, "cuda", True, False, 0.0, False, k=2)
        tref.fused_adam_ref(*want, **kw)
        ops.fused_adam(*got, table=table, **kw)
    first = table.get(got[0], got[2], got[3], got[4])
    got[0][5] = got[0][5].clone()                # new storage for one leaf
    assert table.get(got[0], got[2], got[3], got[4]) is not first
    torch.cuda.synchronize()
    for i in (0, 2, 3):
        assert all(torch.equal(a, b) for a, b in zip(got[i], want[i]))
    assert ops.launches["fused_adam"] == 3
    assert ops.launches["fused_adam_ref"] == 0


@pytest.mark.gpu
def test_cuda_kstep_local_steps_make_no_host_sync():
    """KStepAdam's local steps on the card: no synchronizing call (sync
    debug mode "error") and the same bits as the plain version's steps."""
    _cuda_or_skip()
    from repro_torch.core import kstep as tk

    gen = torch.Generator().manual_seed(6)
    tree = {"w": torch.randn((2, 64, 33), generator=gen),
            "b": [torch.randn((2, 5), generator=gen)]}
    out = []
    for device in ("cuda", "cpu"):
        opt = tk.KStepAdam(tk.KStepConfig(lr=1e-2, k=4, merge="two_phase"), 2)
        p = tk.tree_map(lambda x: x.clone().to(device), tree)
        s = opt.init(p)
        g = tk.tree_map(lambda x: (x * 0.1).to(device), tree)
        for step in range(1, 4):
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                opt.step(p, g, s, merge=False)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        out.append(p)
    torch.testing.assert_close(out[0]["w"].cpu(), out[1]["w"], rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------- the staged push (kernel 7)
@pytest.mark.gpu
@pytest.mark.parametrize("rows,D,n_ids,capacity", [
    (5000, 64, 900, 1024),       # pads
    (3000, 16, 600, 512),        # odd width, pads
    (4000, 100, 700, 256),       # overflow: no pads
    (900, 3, 500, 333),          # no float4 path
])
def test_cuda_staged_push_matches_plain_version_and_host_push(rows, D,
                                                              n_ids,
                                                              capacity):
    """Kernel 7 over staged rows against its plain version on the card and
    against the host push on a resident table: bit-equal at every valid
    position, pads unchanged, two runs bit-equal."""
    _cuda_or_skip()
    from repro_torch.kernels.sparse_adagrad import sparse_adagrad_staged_cuda

    table, accum, uids, grads = _push_case(17, rows, D, n_ids, capacity)
    table, accum, uids, grads = (x.cuda() for x in (table, accum, uids,
                                                    grads))
    staged = table[uids.long()], accum[uids.long()]
    want = tref.sparse_adagrad_ref(staged[0].clone(), staged[1].clone(),
                                   grads, 0.5, 1e-10)
    runs = []
    for _ in range(2):
        r, a = staged[0].clone(), staged[1].clone()
        out = sparse_adagrad_staged_cuda(r, a, grads, lr=0.5, eps=1e-10)
        torch.cuda.synchronize()
        assert out[0] is r and out[1] is a
        runs.append((r, a))
    for r, a in runs:
        assert torch.equal(r, want[0]) and torch.equal(a, want[1])
    t, ac = table.clone(), accum.clone()
    ops.sparse_adagrad_apply(t, ac, uids, grads, lr=0.5, eps=1e-10)
    valid = torch.cat([torch.ones(1, dtype=torch.bool, device="cuda"),
                       uids[1:] > uids[:-1]])
    assert torch.equal(runs[0][0][valid], t[uids[valid].long()])
    assert torch.equal(runs[0][1][valid], ac[uids[valid].long()])
    assert torch.equal(runs[0][0][~valid], staged[0][~valid])   # the pads


@pytest.mark.gpu
@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_cuda_disk_store_trains_as_the_host_store(placement, tmp_path):
    """The SSD tier on the card: a small trainer on the DiskStore (bounded
    page cache) against the same trainer on the host store, losses and
    predictions bit-equal; the staged push ran as kernel 7 on gather."""
    _cuda_or_skip()
    from repro_torch.configs import baidu_ctr
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.trainer import TrainerConfig

    smoke = baidu_ctr.SMOKE
    gen = recsys_batches(smoke, batch=48, seed=1)
    batches = [next(gen) for _ in range(5)]
    out = []
    for store in ("host", "disk"):
        disk = store == "disk"
        tcfg = TrainerConfig(
            n_pod=2, kstep=KStepConfig(k=3), capacity=512,
            placement=placement,
            cache_rows=1024 if placement == "cached" else None, store=store,
            spill_dir=str(tmp_path / "spill") if disk else None,
            page_rows=256 if disk else None,
            page_cache_pages=8 if disk else None)
        tr = build_trainer("baidu-ctr", tcfg, seed=2, device="cuda")
        ops.reset_launches()
        losses = [tr.train_step(b) for b in batches]
        pred = tr.predict(batches[0])
        launches = dict(ops.launches)
        out.append((torch.stack(losses).cpu(), pred, launches))
        tr.close()
    assert torch.equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    staged = out[1][2]
    assert staged["sparse_adagrad"] == (5 if placement == "gather" else 0)
    assert all(v == 0 for k, v in staged.items() if k.endswith("_ref"))
    assert staged["fused_adam"] == 4                 # steps 1, 2, 4, 5


# ---- kernel 8, DLRM's dot interaction (phase 10 (a)'s shapes; the
# reference kernel test's tolerances: the sums run in other orders)
DOT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


DOT_SHAPES = [
    (512, 27, 128, torch.float32), (16384, 27, 128, torch.float32),
    (33, 13, 17, torch.float32), (512, 27, 128, torch.bfloat16),
    (100, 2, 128, torch.float32), (7, 1, 128, torch.float32),
    (3, 300, 50, torch.float32), (5, 27, 3001, torch.bfloat16),
    # F around the tiles' edges of four rows, B = 1, B not a multiple of
    # the instances a block takes (3 at F = 13 and 10 at F = 5 when B is
    # large), D = 17 and 3001 (chunked) in f32, F = 300 in opt-in shared
    # memory, and bf16 at the path's shape
    (1, 27, 128, torch.float32), (1, 29, 128, torch.bfloat16),
    (16383, 28, 128, torch.float32), (1027, 29, 64, torch.float32),
    (2049, 26, 17, torch.float32), (2050, 13, 17, torch.float32),
    (4097, 5, 64, torch.float32), (9, 27, 3001, torch.float32),
    (6, 300, 128, torch.float32), (16383, 27, 128, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,F,D,dtype", DOT_SHAPES)
def test_cuda_dot_interaction_matches_plain_version(B, F, D, dtype):
    _cuda_or_skip()
    from repro_torch.kernels.dot_interaction import dot_interaction_cuda

    gen = torch.Generator("cuda").manual_seed(B + F + D)
    feats = torch.randn((B, F, D), generator=gen, device="cuda").to(dtype)
    got = dot_interaction_cuda(feats)
    again = dot_interaction_cuda(feats)
    torch.cuda.synchronize()
    want = tref.dot_interaction_ref(feats)
    assert got.dtype == dtype and got.shape == (B, F * (F - 1) // 2)
    assert torch.equal(got, again)
    tol = DOT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol * D,
                               rtol=tol * 4)


# ---- kernel 8b, the interaction's backward, at the forward's shapes (the
# training shape of one pod, 32768 x 27 x 128, among them).  Tolerance: the
# forward's, with the sum's length F in place of D (each output element
# adds F - 1 products, in another order than the plain einsum).
@pytest.mark.gpu
@pytest.mark.parametrize("B,F,D,dtype",
                         DOT_SHAPES + [(32768, 27, 128, torch.float32)])
def test_cuda_dot_interaction_backward_matches_plain_version(B, F, D, dtype):
    _cuda_or_skip()
    from repro_torch.kernels.dot_interaction import (
        dot_interaction_backward_cuda,
    )

    gen = torch.Generator("cuda").manual_seed(B + F + D + 1)
    feats = torch.randn((B, F, D), generator=gen, device="cuda").to(dtype)
    g = torch.randn((B, F * (F - 1) // 2), generator=gen,
                    device="cuda").to(dtype)
    got = dot_interaction_backward_cuda(g, feats)
    again = dot_interaction_backward_cuda(g, feats)
    torch.cuda.synchronize()
    want = tref.dot_interaction_backward_ref(g, feats)
    assert got.dtype == dtype and got.shape == (B, F, D)
    assert torch.equal(got, again)
    if F == 1:
        assert not got.any()
    tol = DOT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol * F,
                               rtol=tol * 4)


@pytest.mark.gpu
def test_cuda_dot_interaction_backward_takes_a_contiguous_g():
    """The wrapper refuses a strided g; the autograd function makes the
    column slice DLRM's tower hands it contiguous, with the same bits."""
    _cuda_or_skip()
    from repro_torch.kernels.dot_interaction import (
        dot_interaction_backward_cuda,
    )

    gen = torch.Generator("cuda").manual_seed(3)
    feats = torch.randn((300, 27, 128), generator=gen, device="cuda")
    wide = torch.randn((300, 128 + 351), generator=gen, device="cuda")
    g = wide[:, 128:]
    assert not g.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        dot_interaction_backward_cuda(g, feats)
    with pytest.raises(ValueError, match="g must be"):
        dot_interaction_backward_cuda(g.contiguous()[:, 1:], feats)
    x = feats.clone().requires_grad_(True)
    top_in = torch.cat([torch.zeros(300, 128, device="cuda"),
                        ops.dot_interaction(x)], dim=1)
    (got,) = torch.autograd.grad(top_in, x, wide)
    assert torch.equal(got, dot_interaction_backward_cuda(g.contiguous(),
                                                          feats))


@pytest.mark.gpu
def test_cuda_dot_interaction_launches_the_kernels_both_ways():
    _cuda_or_skip()
    feats = torch.randn((64, 27, 128), device="cuda")
    ops.reset_launches()
    out = ops.dot_interaction(feats)
    torch.cuda.synchronize()
    assert ops.launches["dot_interaction"] == 1
    assert ops.launches["dot_interaction_ref"] == 0
    assert out.shape == (64, 351)
    x = feats.clone().requires_grad_(True)
    ops.dot_interaction(x).sum().backward()
    torch.cuda.synchronize()
    assert ops.launches["dot_interaction"] == 2
    assert ops.launches["dot_interaction_backward"] == 1
    assert ops.launches["dot_interaction_backward_ref"] == 0
    want = tref.dot_interaction_backward_ref(
        torch.ones((64, 351), device="cuda"), feats)
    torch.testing.assert_close(x.grad, want, atol=27 * 1e-5, rtol=4e-5)
    with pytest.raises(ValueError, match="contiguous"):
        ops.dot_interaction(feats.transpose(1, 2))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.dot_interaction(feats.double())


# ---- DLRM training on the card (smoke size): the takes' backward (kernel
# 1b, the takes being bags of one id) and kernel 8b give the same bits run
# after run, and the cached full mirror trains as gather.
def _dlrm_run(placement="gather", cache_rows=None, steps=4):
    from repro_torch.core.kstep import KStepConfig, leaves
    from repro_torch.data.synthetic import dlrm_batches
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.trainer import TrainerConfig

    tcfg = TrainerConfig(n_pod=2, kstep=KStepConfig(k=2), log_every=1,
                         placement=placement, cache_rows=cache_rows)
    tr = build_trainer("dlrm-mlperf", tcfg, seed=3, device="cuda")
    rows = tr.engine.specs["emb_00"].rows
    stream = dlrm_batches(seed=5, batch=64, rows=(rows,) * 26)
    ops.reset_launches()
    losses = torch.stack([tr.train_step(next(stream))
                          for _ in range(steps)]).cpu()
    launches = dict(ops.launches)
    tables, accum, _ = tr.engine.flush(tr.tables, tr.sparse_state.accum,
                                       tr.backend_state)
    return (losses, {n: t.cpu() for n, t in tr.engine.export(tables).items()},
            {n: a.cpu() for n, a in accum.items()},
            [x.cpu() for x in leaves(tr.dense)], launches)


def _assert_runs_equal(a, b):
    assert torch.equal(a[0], b[0])
    for n in a[1]:
        assert torch.equal(a[1][n], b[1][n]), n
        assert torch.equal(a[2][n], b[2][n]), n
    assert all(torch.equal(x, y) for x, y in zip(a[3], b[3]))


@pytest.mark.gpu
def test_cuda_dlrm_training_gives_the_same_bits_twice():
    _cuda_or_skip()
    first, second = _dlrm_run(), _dlrm_run()
    assert torch.isfinite(first[0]).all()
    _assert_runs_equal(first, second)
    launches = first[4]
    assert launches["dot_interaction"] == 4 * 2
    assert launches["dot_interaction_backward"] == 4 * 2
    assert launches["embedding_bag"] == launches[
        "embedding_bag_backward"] == 4 * 2 * 26
    assert launches["sparse_adagrad_apply"] == 4 * 26
    assert not any(v for k, v in launches.items() if k.endswith("_ref"))


@pytest.mark.gpu
def test_cuda_dlrm_cached_mirror_equals_gather():
    _cuda_or_skip()
    gather = _dlrm_run()
    cached = _dlrm_run("cached", cache_rows=256)   # smoke: 200 rows a table
    _assert_runs_equal(gather, cached)
    assert cached[4]["sparse_adagrad_cached_apply"] == 4 * 26
    assert cached[4]["dot_interaction_backward"] == 4 * 2


# ---- kernel 9, flash attention (phase 11 (a)'s small shapes and the edges
# the kernels take: ragged S, hd 8 to 256 in multiples of 8, GQA; bfloat16
# runs the mma kernel, float32 the fma kernel).
# Tolerances: float32 atol = rtol = 1e-5 (the same float32 math, the dot
# products and sums in another order); bfloat16 atol 4e-3, rtol 8e-3 (the
# same float32 math up to p's two bf16 halves, each output then rounded to
# 8 bits: an ulp apart).
FLASH_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=4e-3, rtol=8e-3)}


def _qkv(B, S, H, Kv, hd, dtype, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd))]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kv,hd,dtype", [
    (2, 64, 8, 2, 16, torch.float32), (2, 96, 4, 2, 32, torch.float32),
    (1, 1000, 8, 2, 128, torch.bfloat16), (1, 257, 4, 4, 128, torch.float32),
    (3, 5, 2, 1, 8, torch.float32), (1, 130, 2, 1, 40, torch.bfloat16),
    (1, 70, 2, 1, 256, torch.float32), (1, 1, 4, 2, 64, torch.bfloat16),
    (2, 15, 5, 1, 8, torch.bfloat16), (1, 17, 8, 1, 256, torch.bfloat16),
    (2, 63, 4, 4, 64, torch.bfloat16), (1, 65, 10, 2, 128, torch.bfloat16),
    (1, 1, 2, 2, 8, torch.bfloat16), (2, 129, 8, 8, 128, torch.bfloat16),
    (1, 1000, 8, 1, 256, torch.bfloat16), (1, 1000, 5, 1, 64, torch.bfloat16),
    (1, 300, 16, 2, 8, torch.bfloat16), (1, 96, 8, 1, 136, torch.bfloat16),
    (1, 1024, 40, 8, 128, torch.bfloat16), (1, 1000, 40, 8, 128, torch.bfloat16),
])
def test_cuda_flash_attention_matches_plain_version(B, S, H, Kv, hd, dtype,
                                                    causal):
    """Within FLASH_TOL, two runs bit-equal, and in bfloat16 every output
    within one bf16 ulp of the plain version's (``bf16_ulps``: p's two
    halves carry it to ~2^-18, the sums are float32)."""
    _cuda_or_skip()
    from repro_torch.kernels.flash_attention import (bf16_ulps,
                                                     flash_attention_cuda)

    q, k, v = _qkv(B, S, H, Kv, hd, dtype, seed=S + hd)
    got = flash_attention_cuda(q, k, v, causal)
    again = flash_attention_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    want = tref.flash_attention_ref(q, k, v, causal)
    assert got.dtype == dtype and got.shape == (B, S, H, hd)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    if dtype == torch.bfloat16:
        assert bf16_ulps(got, want).max().item() <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_attention_prefix_is_bit_equal(dtype):
    """Causal rows do not depend on S: a 1 x 2048 run equals a 1 x 256 run
    bit for bit on the first 256 positions (phase 11 (c) at test size)."""
    _cuda_or_skip()
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = _qkv(1, 2048, 8, 2, 128, dtype, seed=11)
    long = flash_attention_cuda(q, k, v, True)
    short = flash_attention_cuda(*(x[:, :256].contiguous() for x in (q, k, v)),
                                 True)
    assert torch.equal(long[:, :256], short)


@pytest.mark.gpu
def test_cuda_flash_attention_launches_the_kernels_both_ways(tmp_path):
    """One counted launch per forward call; a CUDA graph captured around
    the calls holds the fma kernel for float32 and the mma kernel for
    bfloat16, as ``cudaGraphDebugDotPrint`` names them.  Under autograd
    the backward is kernel 9b (counted once per backward, the same bits
    as the wrapper's call, whose graph holds its dtype's three kernels:
    D, then dK and dV, then dQ, the mma kernels for bfloat16) and no plain
    version runs."""
    _cuda_or_skip()
    q, k, v = _qkv(2, 96, 4, 2, 32, torch.float32, seed=3)
    half = [x.to(torch.bfloat16) for x in (q, k, v)]
    ops.reset_launches()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        out = ops.flash_attention(q, k, v)
        ops.flash_attention(*half)
    dot = tmp_path / "graph.dot"
    graph.debug_dump(str(dot))
    dot = dot.read_text()
    assert dot.count("flash_attention_kernel") == 1
    assert dot.count("flash_attention_mma_kernel") == 1
    assert ops.launches["flash_attention"] == 2
    assert ops.launches["flash_attention_ref"] == 0
    assert out.shape == q.shape
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)

    for xs in ((q, k, v), half):
        xs = [x.clone().requires_grad_(True) for x in xs]
        o = ops.flash_attention(*xs)
        grads = torch.autograd.grad(o, xs, torch.ones_like(o))
        assert [t.shape for t in grads] == [x.shape for x in xs]
        plain = [x.detach() for x in xs]
        out, lse = flash_attention_cuda(*plain, True, return_lse=True)
        want = flash_attention_backward_cuda(*plain, out, lse,
                                             torch.ones_like(o), True)
        assert all(torch.equal(a, b) for a, b in zip(grads, want))
        bwd = torch.cuda.CUDAGraph(keep_graph=True)
        bwd.enable_debug_mode()
        with torch.cuda.graph(bwd):
            flash_attention_backward_cuda(*plain, out, lse,
                                          torch.ones_like(o), True)
        path = tmp_path / f"bwd_{xs[0].dtype}.dot"
        bwd.debug_dump(str(path))
        text = path.read_text()
        mma = "_mma" if xs[0].dtype == torch.bfloat16 else ""
        ran = ("flash_attention_bwd_delta_kernel",
               f"flash_attention_bwd_kv{mma}_kernel",
               f"flash_attention_bwd_q{mma}_kernel")
        for name in ("flash_attention_bwd_delta_kernel",
                     "flash_attention_bwd_kv_kernel",
                     "flash_attention_bwd_q_kernel",
                     "flash_attention_bwd_kv_mma_kernel",
                     "flash_attention_bwd_q_mma_kernel"):
            assert text.count(name) == (name in ran), name
    assert ops.launches["flash_attention_backward"] == 2
    assert ops.launches["flash_attention_backward_ref"] == 0


FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kv,hd,dtype", [
    (2, 64, 8, 2, 16, torch.float32), (1, 257, 4, 4, 128, torch.float32),
    (3, 5, 2, 1, 8, torch.float32), (1, 70, 2, 1, 256, torch.float32),
    (1, 1000, 8, 2, 128, torch.bfloat16), (2, 63, 4, 4, 64, torch.bfloat16),
    (1, 130, 10, 2, 40, torch.bfloat16), (1, 17, 8, 1, 256, torch.bfloat16),
    (1, 1, 4, 2, 64, torch.bfloat16), (1, 512, 40, 8, 128, torch.bfloat16),
    # the mma kernels' tile edges (128 kv rows a dK/dV block, 64-row q
    # stages, 128 q rows a dQ block), G 1 and 8, hd 40 and 256
    (1, 127, 40, 8, 128, torch.bfloat16), (1, 128, 40, 8, 128, torch.bfloat16),
    (1, 129, 40, 8, 128, torch.bfloat16), (1, 4095, 40, 8, 128, torch.bfloat16),
    (1, 129, 8, 8, 128, torch.bfloat16), (1, 200, 16, 2, 64, torch.bfloat16),
    (2, 129, 4, 2, 40, torch.bfloat16), (1, 257, 4, 1, 256, torch.bfloat16),
])
def test_cuda_flash_attention_backward_matches_plain_vjp(B, S, H, Kv, hd,
                                                         dtype, causal):
    """Kernel 9b against ``ref.flash_attention_backward_ref`` (autograd's
    vjp of the plain version) on the card: every gradient within
    FLASH_BWD_TOL times its largest magnitude, or times 1 where that is
    below 1 (the inputs are standard normal, so a gradient's sums are of
    order 1; at S 1, dq and dk are 0 up to that noise): float32, the same
    float32 math summed in another order; bfloat16, P and dS rounded once
    to bf16 as the products' operands, one bf16 rounding of each gradient,
    and D = rowsum(dO o) from the bf16 output where the plain vjp has the
    float32 one (the CPU model of those roundings stays within 7.4e-3,
    ``tests/test_torch_flash_backward_bf16.py``).  The forward's
    log-sum-exp within 1e-5 of ``ref.flash_attention_lse_ref`` and its
    output the same bits as without it; two backward runs bit-equal."""
    _cuda_or_skip()
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)

    q, k, v = _qkv(B, S, H, Kv, hd, dtype, seed=S + hd + 1)
    dout = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(
        S), device="cuda").to(dtype)
    out, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal))
    torch.testing.assert_close(lse, tref.flash_attention_lse_ref(q, k, causal),
                               atol=1e-5, rtol=1e-5)
    got = flash_attention_backward_cuda(q, k, v, out, lse, dout, causal)
    again = flash_attention_backward_cuda(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    want = tref.flash_attention_backward_ref(q, k, v, dout, causal)
    for name, a, b, c in zip("qkv", got, again, want):
        assert a.dtype == dtype and a.shape == c.shape, name
        assert torch.equal(a, b), name
        scale = max(c.float().abs().max().item(), 1.0)
        err = (a.float() - c.float()).abs().max().item()
        assert err <= FLASH_BWD_TOL[dtype] * scale, (name, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("lr_tensor", [False, True])
@pytest.mark.parametrize("bias,wd", [(False, 0.0), (True, 1e-4)])
@pytest.mark.parametrize("warmup,t", [(True, 3), (True, 25), (False, 3)])
def test_cuda_fused_adam_bf16_leaves_match_plain_version(warmup, t, bias, wd,
                                                         lr_tensor):
    """Kernel 6 on bfloat16 params and gradients (float32 moments), mixed
    with float32 leaves in one call: one launch, params and moments bit-
    equal to the plain version on the card."""
    _cuda_or_skip()
    from repro_torch.kernels.fused_adam import fused_adam_cuda

    sizes = [4096, 1, 1310720, 513, 131071, 7]
    leaves = list(_adam_leaves(8, sizes, "cuda"))
    for grp in (0, 1):
        leaves[grp] = [x.to(torch.bfloat16) if i % 2 == 0 else x
                       for i, x in enumerate(leaves[grp])]
    kw = _adam_kwargs(t, "cuda", warmup, bias, wd, lr_tensor)
    want = [[x.clone() for x in grp] for grp in leaves]
    tref.fused_adam_ref(*want, **kw)
    got = [[x.clone() for x in grp] for grp in leaves]
    ops.reset_launches()
    ops.fused_adam(*got, **kw)
    torch.cuda.synchronize()
    assert ops.launches["fused_adam"] == 1
    for i in (0, 2, 3):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="gradient 0"):
        fused_adam_cuda(got[0], [g.float() for g in got[1]], *got[2:], **kw)


def _smoke_trainer(device, state=None, **kstep):
    """qwen3-14b's smoke config (float32) on a ``DenseTrainer`` from one
    state drawn on the CPU: n_pod 2, k 2, lr 1e-4."""
    from repro_torch import configs, tree_map
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig

    cfg = configs.get("qwen3-14b").smoke_cfg
    if state is None:
        state = T.init_params(torch.Generator("cpu").manual_seed(5), cfg,
                              device="cpu")
    return cfg, DenseTrainer(
        lambda p, b: T.loss_fn(p, b, cfg),
        tree_map(lambda t: t.clone().to(device), state),
        TrainerConfig(n_pod=2, kstep=KStepConfig(lr=1e-4, k=2, **kstep)),
        device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("merge", ["two_phase", "int8_ef"])
def test_cuda_dense_trainer_matches_the_cpu(merge):
    """Four ``DenseTrainer`` steps (two merges) of the smoke LM on the card
    and on the CPU from one state: losses, parameters and moments within
    rtol 1e-4, atol 1e-6 (phase 6's tolerance: float32 sums in other
    orders, carried through Adam); each step launches kernel 9 twice and
    9b once per layer and pod and kernel 6 on the local steps on the card,
    their plain versions as often on the CPU."""
    _cuda_or_skip()
    from repro_torch.core.kstep import leaves
    from repro_torch.data.synthetic import lm_batches

    cfg, cpu = _smoke_trainer("cpu", merge=merge)
    _, gpu = _smoke_trainer("cuda", merge=merge)
    gen = lm_batches(seed=0, batch=4, seq_len=64, vocab=cfg.vocab)
    ops.reset_launches()
    for _ in range(4):
        b = next(gen)
        want = cpu.train_step(b)
        got = gpu.train_step(b)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-6)
    n = 4 * 2 * cfg.n_layers
    assert ops.launches["flash_attention"] == 2 * n
    assert ops.launches["flash_attention_backward"] == n
    assert ops.launches["fused_adam"] == 2
    assert ops.launches["flash_attention_ref"] == 2 * n
    assert ops.launches["fused_adam_ref"] == 2
    for a, b in zip(leaves(gpu.params) + leaves(gpu.opt_state.m),
                    leaves(cpu.params) + leaves(cpu.opt_state.m)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_cuda_dense_trainer_step_makes_no_host_sync():
    """A local and a merge step of the smoke LM in bfloat16 on the card
    under the sync debug mode "error" (the batch from pinned memory, the
    loss a device tensor): finite losses; the gradient buffers and the
    parameters keep their storage."""
    _cuda_or_skip()
    import dataclasses

    from repro_torch import configs, tree_map
    from repro_torch.core.kstep import KStepConfig, leaves
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig

    cfg = dataclasses.replace(configs.get("qwen3-14b").smoke_cfg,
                              dtype=torch.bfloat16)
    params = T.init_params(torch.Generator("cuda").manual_seed(5), cfg,
                           device="cuda")
    tr = DenseTrainer(lambda p, b: T.loss_fn(p, b, cfg), params,
                      TrainerConfig(n_pod=2, kstep=KStepConfig(k=2)),
                      device="cuda")
    gen = lm_batches(seed=0, batch=4, seq_len=64, vocab=cfg.vocab)
    tr.train_step(next(gen))                     # warm-up: builds, tables
    ptrs = [x.data_ptr() for x in leaves(tr.params) + leaves(tr.grads)]
    torch.cuda.synchronize()
    losses = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            losses.append(tr.train_step(next(gen)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.isfinite(x).item() for x in losses)
    assert [x.data_ptr() for x in leaves(tr.params) + leaves(tr.grads)] == ptrs
    assert all(x.dtype == torch.bfloat16 for x in leaves(tr.params))


@pytest.mark.gpu
def test_cuda_flash_attention_rejects_what_it_does_not_take():
    _cuda_or_skip()
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = _qkv(1, 32, 4, 2, 16, torch.float32, seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q.cpu(), k, v)
    with pytest.raises(ValueError, match="multiple of Kv"):
        flash_attention_cuda(*_qkv(1, 32, 6, 4, 16, torch.float32, seed=5))
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_cuda(*_qkv(1, 32, 4, 2, 12, torch.float32, seed=6))
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_cuda(*_qkv(1, 32, 4, 2, 264, torch.float32, seed=7))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_cuda(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="k and v"):
        flash_attention_cuda(q, k[:, :16].contiguous(), v[:, :16].contiguous())


def _smoke_lm():
    """qwen3-14b's smoke config (float32) and a state drawn on the CPU."""
    from repro_torch import configs
    from repro_torch.models import transformer as T

    cfg = configs.get("qwen3-14b").smoke_cfg
    return cfg, T.init_params(torch.Generator("cpu").manual_seed(7), cfg,
                              device="cpu")


@pytest.mark.gpu
def test_cuda_decode_matches_the_cpu():
    """20 decode steps of 3 slots on the card and on the CPU from one state:
    logits within atol 5e-5, rtol 1e-5 (float32 products summed in other
    orders), the caches' positions equal."""
    _cuda_or_skip()
    from repro_torch import tree_map
    from repro_torch.models import transformer as T

    cfg, cpu = _smoke_lm()
    gpu = tree_map(lambda t: t.cuda(), cpu)
    ccache = T.init_cache(cfg, 3, 32, device="cpu")
    gcache = T.init_cache(cfg, 3, 32, device="cuda")
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (20, 3))
    for tok in torch.from_numpy(tokens):
        want, ccache = T.decode_step(cpu, ccache, tok, cfg)
        got, gcache = T.decode_step(gpu, gcache, tok, cfg)
        torch.testing.assert_close(got.cpu(), want, atol=5e-5, rtol=1e-5)
    assert torch.equal(gcache["pos"].cpu(), ccache["pos"])
    assert int(gcache["t"]) == int(ccache["t"]) == 20


@pytest.mark.gpu
def test_cuda_decode_step_makes_no_sync_and_keeps_the_cache_in_place():
    """A decode step with its token ids in pinned host memory runs under the
    sync debug mode "error"; the cache keeps its storage and the step
    allocates less than one layer's K (no copy of K or V, no second
    cache)."""
    _cuda_or_skip()
    from repro_torch import tree_map
    from repro_torch.models import transformer as T

    cfg, cpu = _smoke_lm()
    params = tree_map(lambda t: t.cuda(), cpu)
    cache = T.init_cache(cfg, 4, 4096, device="cuda")
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    layer_bytes = cache["k"][0].numel() * cache["k"].element_size()
    tokens = torch.tensor([1, 2, 3, 4], dtype=torch.int32).pin_memory()
    T.decode_step(params, cache, tokens, cfg)            # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, out = T.decode_step(params, cache, tokens, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out is cache
    assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
    assert torch.cuda.max_memory_allocated() - base < layer_bytes
    assert logits.shape == (4, cfg.vocab)
    assert torch.isfinite(logits).all()
    assert int(cache["t"]) == 2 and cache["pos"][:3].tolist() == [0, 1, -1]


# ------------------------------------- kernel 9's window and chunk terms
@pytest.mark.gpu
@pytest.mark.parametrize("window,chunk", [
    (64, None), (40, None), (None, 64), (None, 48), (100, 96), (17, None),
    (None, 7),
])
@pytest.mark.parametrize("B,S,H,Kv,hd,dtype", [
    (1, 300, 8, 2, 128, torch.bfloat16), (2, 257, 4, 1, 64, torch.float32),
    (1, 1000, 8, 2, 128, torch.bfloat16), (1, 130, 4, 2, 32, torch.float32),
    (1, 200, 2, 1, 256, torch.bfloat16), (1, 77, 4, 2, 256, torch.float32),
])
def test_cuda_flash_attention_local_terms_match_plain_version(
        B, S, H, Kv, hd, dtype, window, chunk):
    """Kernel 9 under a window or a chunk (or both) against its plain
    version: windows below and above a tile (64 rows), chunks that do and
    do not divide S, S not a multiple of the tile; within FLASH_TOL, two
    runs bit-equal, bf16 within one bf16 ulp; the row log-sum-exp too."""
    _cuda_or_skip()
    from repro_torch.kernels.flash_attention import (bf16_ulps,
                                                     flash_attention_cuda)

    q, k, v = _qkv(B, S, H, Kv, hd, dtype, seed=S + hd + (window or 0))
    got, lse = flash_attention_cuda(q, k, v, True, return_lse=True,
                                    window=window, chunk=chunk)
    again = flash_attention_cuda(q, k, v, True, window=window, chunk=chunk)
    torch.cuda.synchronize()
    want = tref.flash_attention_ref(q, k, v, True, window, chunk)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    if dtype == torch.bfloat16:
        assert bf16_ulps(got, want).max().item() <= 1.0
    torch.testing.assert_close(
        lse, tref.flash_attention_lse_ref(q, k, True, window, chunk),
        atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_attention_unbinding_terms_are_causal_bits(dtype):
    """A window or a chunk of S or more masks nothing past causal: the
    local kernel gives the causal kernel's bits (output and lse)."""
    _cuda_or_skip()
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = _qkv(1, 1000, 8, 2, 128, dtype, seed=21)
    want, want_lse = flash_attention_cuda(q, k, v, True, return_lse=True)
    for kw in (dict(window=1000), dict(window=4096), dict(chunk=1000),
               dict(chunk=8192), dict(window=5000, chunk=1024)):
        got, lse = flash_attention_cuda(q, k, v, True, return_lse=True, **kw)
        assert torch.equal(got, want), kw
        assert torch.equal(lse, want_lse), kw


@pytest.mark.gpu
def test_cuda_flash_attention_local_terms_count_and_refuse_the_backward():
    """``ops`` counts a windowed launch as flash_attention_window and a
    chunked one as flash_attention_chunk, and the backward of either runs
    kernel 9b with the same terms, counted as
    flash_attention_backward_window / _chunk: its gradients within
    FLASH_BWD_TOL of the CPU's plain vjp.  Bad terms raise in either
    direction."""
    _cuda_or_skip()
    q, k, v = _qkv(1, 128, 4, 2, 64, torch.bfloat16, seed=3)
    ops.reset_launches()
    ops.flash_attention(q, k, v, window=32)
    ops.flash_attention(q, k, v, chunk=32)
    ops.flash_attention(q, k, v)
    assert (ops.launches["flash_attention_window"],
            ops.launches["flash_attention_chunk"],
            ops.launches["flash_attention"]) == (1, 1, 1)
    for dtype in (torch.bfloat16, torch.float32):
        for kw, name in ((dict(window=32), "window"),
                         (dict(chunk=32), "chunk")):
            xs = [x.detach().to(dtype).clone().requires_grad_(True)
                  for x in (q, k, v)]
            ops.reset_launches()
            out = ops.flash_attention(*xs, **kw)
            g = torch.randn(out.shape, device="cuda").to(dtype)
            out.backward(g)
            assert ops.launches[f"flash_attention_backward_{name}"] == 1
            assert ops.launches["flash_attention_backward"] == 0
            assert ops.launches["flash_attention_backward_ref"] == 0
            cpu = [x.detach().cpu().float().requires_grad_(True) for x in xs]
            ops.flash_attention(*cpu, **kw).backward(g.cpu().float())
            for a, b in zip(xs, cpu):
                scale = max(b.grad.abs().max().item(), 1.0)
                err = (a.grad.cpu().float() - b.grad).abs().max().item()
                assert err <= FLASH_BWD_TOL[dtype] * scale, (kw, dtype, err)
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(q, k, v, causal=False, window=8)
    with pytest.raises(ValueError, match="causal"):
        from repro_torch.kernels.flash_attention import (
            flash_attention_backward_cuda)

        flash_attention_backward_cuda(q, k, v, q, torch.zeros(
            (1, 4, 128), device="cuda"), q, causal=False, chunk=8)


# ----------------------------------- kernel 9b's window and chunk terms
@pytest.mark.gpu
@pytest.mark.parametrize("window,chunk", [
    (64, None), (17, None), (100, None), (129, None), (None, 64),
    (None, 48), (None, 7), (None, 130), (100, 96), (200, 256),
])
@pytest.mark.parametrize("B,S,H,Kv,hd,dtype", [
    (1, 300, 8, 2, 128, torch.bfloat16), (2, 257, 4, 1, 64, torch.float32),
    (1, 1000, 40, 8, 128, torch.bfloat16), (1, 130, 4, 2, 32, torch.float32),
    (1, 200, 2, 1, 256, torch.bfloat16), (1, 77, 4, 2, 256, torch.float32),
    (2, 129, 4, 2, 40, torch.bfloat16), (1, 513, 40, 8, 128, torch.float32),
])
def test_cuda_flash_attention_backward_local_terms_match_plain_vjp(
        B, S, H, Kv, hd, dtype, window, chunk):
    """Kernel 9b under a window or a chunk (or both) against
    ``ref.flash_attention_backward_ref`` with the same terms: windows
    below one tile and across the mma kernels' 128-row blocks, chunks
    that do and do not divide S, S not a multiple of any tile, hd 32 to
    256, H 40 over Kv 8; every gradient within FLASH_BWD_TOL of its
    largest magnitude (or of 1), as the causal backward; two runs
    bit-equal."""
    _cuda_or_skip()
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)

    q, k, v = _qkv(B, S, H, Kv, hd, dtype, seed=S + hd + (chunk or 0))
    dout = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(
        S + 1), device="cuda").to(dtype)
    kw = dict(window=window, chunk=chunk)
    out, lse = flash_attention_cuda(q, k, v, True, return_lse=True, **kw)
    got = flash_attention_backward_cuda(q, k, v, out, lse, dout, True, **kw)
    again = flash_attention_backward_cuda(q, k, v, out, lse, dout, True, **kw)
    torch.cuda.synchronize()
    want = tref.flash_attention_backward_ref(q, k, v, dout, True, window,
                                             chunk)
    for name, a, b, c in zip("qkv", got, again, want):
        assert a.dtype == dtype and a.shape == c.shape, name
        assert torch.equal(a, b), name
        scale = max(c.float().abs().max().item(), 1.0)
        err = (a.float() - c.float()).abs().max().item()
        assert err <= FLASH_BWD_TOL[dtype] * scale, (name, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_attention_backward_unbinding_terms_are_causal_bits(
        dtype):
    """A window or a chunk of S or more masks nothing past causal: kernel
    9b with such terms gives the causal backward's bits."""
    _cuda_or_skip()
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)

    q, k, v = _qkv(1, 1000, 8, 2, 128, dtype, seed=23)
    dout = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(
        24), device="cuda").to(dtype)
    out, lse = flash_attention_cuda(q, k, v, True, return_lse=True)
    want = flash_attention_backward_cuda(q, k, v, out, lse, dout, True)
    for kw in (dict(window=1000), dict(window=4096), dict(chunk=1000),
               dict(chunk=8192), dict(window=5000, chunk=1024)):
        got = flash_attention_backward_cuda(q, k, v, out, lse, dout, True,
                                            **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), kw


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-16e"])
def test_cuda_moe_backward_is_bit_reproducible_and_matches_the_cpu(arch):
    """The MoE FFN's backward on the card (autograd through
    ``moe.moe_ffn``, with the aux term at 0.01; 8 groups of 64 tokens with
    drops at capacity_factor 0.5): two runs give the same bits, in bf16
    and float32 (each kept buffer row is gathered once, the dump row's
    terms are discarded, the repeat's backward is a fixed-order sum); in
    float32 every gradient within atol 1e-5 of the CPU's (the forward's
    tolerance, ``test_cuda_moe_is_bit_reproducible_and_matches_the_cpu``:
    gy is N(0, 1) / T, as a mean over the T tokens gives it)."""
    _cuda_or_skip()
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(configs.get(arch).smoke_cfg,
                              capacity_factor=0.5)
    cpu = T.init_params(torch.Generator("cpu").manual_seed(2), cfg,
                        device="cpu")
    lp = {n: t[0] for n, t in cpu["layers"].items()
          if n in ("router", "we_gate", "we_up", "we_down", "ws_gate",
                   "ws_up", "ws_down")}
    gen = torch.Generator("cpu").manual_seed(3)
    x = torch.randn((8, 64, cfg.d_model), generator=gen)
    gy = torch.randn(x.shape, generator=gen) / x[..., 0].numel()

    def grads(device, dtype):
        c = dataclasses.replace(cfg, dtype=dtype)
        xs = x.to(device, dtype).requires_grad_(True)
        ps = {n: t.to(device, dtype).requires_grad_(True)
              for n, t in lp.items()}
        y, aux = moe.moe_ffn(xs, ps, c)
        ((y.float() * gy.to(device)).sum() + 0.01 * aux).backward()
        return [xs.grad] + [ps[n].grad for n in sorted(ps)]

    for dtype in (torch.bfloat16, torch.float32):
        one, two = grads("cuda", dtype), grads("cuda", dtype)
        assert all(torch.equal(a, b) for a, b in zip(one, two)), dtype
    for a, b in zip(one, grads("cpu", torch.float32)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-16e"])
def test_cuda_moe_dense_trainer_matches_the_cpu(arch):
    """Four ``DenseTrainer`` steps (n_pod 2, k 2, lr 1e-4: two merges) of
    the arch's smoke config (f32) at S 64, where its window or chunk
    binds, on the card and on the CPU from one state: losses within rtol
    1e-4, atol 1e-6 and parameters and m within rtol 1e-4, atol 1e-5
    (``test_torch_moe_train.TRAIN_MOE``: MoE gradients' float32 noise
    through k-step Adam); on the card each layer and pod launches kernel 9
    twice and 9b once a step, with the layer's terms, and no plain
    version."""
    _cuda_or_skip()
    from repro_torch import configs, tree_map
    from repro_torch.core.kstep import KStepConfig, leaves
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig

    cfg = configs.get(arch).smoke_cfg
    state = T.init_params(torch.Generator("cpu").manual_seed(5), cfg,
                          device="cpu")
    trs = [DenseTrainer(lambda p, b: T.loss_fn(p, b, cfg),
                        tree_map(lambda t: t.clone().to(d), state),
                        TrainerConfig(n_pod=2, kstep=KStepConfig(lr=1e-4,
                                                                 k=2)),
                        device=d) for d in ("cuda", "cpu")]
    gen = lm_batches(seed=0, batch=4, seq_len=64, vocab=cfg.vocab)
    cuda_counts = {}
    for _ in range(4):
        b = next(gen)
        ops.reset_launches()
        got = trs[0].train_step(b)
        torch.cuda.synchronize()
        for key, n in ops.launches.items():
            cuda_counts[key] = cuda_counts.get(key, 0) + n
        want = trs[1].train_step(b)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-6)
    n_local = sum(1 for i in range(cfg.n_layers)
                  if T._local_terms(cfg, i) != {"window": None,
                                                "chunk": None})
    key = "window" if cfg.attn_window else "chunk"
    n = 4 * 2
    assert cuda_counts[f"flash_attention_{key}"] == 2 * n * n_local
    assert cuda_counts[f"flash_attention_backward_{key}"] == n * n_local
    assert cuda_counts["flash_attention"] == 2 * n * (cfg.n_layers - n_local)
    assert cuda_counts["flash_attention_backward"] == n * (cfg.n_layers
                                                          - n_local)
    assert cuda_counts["fused_adam"] == 2
    assert not any(v for k_, v in cuda_counts.items() if k_.endswith("_ref"))
    for a, b in zip(leaves(trs[0].params) + leaves(trs[0].opt_state.m),
                    leaves(trs[1].params) + leaves(trs[1].opt_state.m)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-16e"])
def test_cuda_moe_is_bit_reproducible_and_matches_the_cpu(arch):
    """The MoE FFN on the card (bf16 at the smoke widths, 8 groups of 64
    tokens with drops at capacity_factor 0.5): two runs give the same bits
    (the dispatch writes each kept slot once, the combine adds at most two
    terms onto an exact zero); in float32 the plan equals the CPU's and y
    lies within atol 1e-5."""
    _cuda_or_skip()
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(configs.get(arch).smoke_cfg,
                              capacity_factor=0.5)
    cpu = T.init_params(torch.Generator("cpu").manual_seed(2), cfg,
                        device="cpu")
    lp = {n: t[0] for n, t in cpu["layers"].items()}
    x = torch.randn((8, 64, cfg.d_model),
                    generator=torch.Generator("cpu").manual_seed(3))
    for dtype in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, dtype=dtype)
        glp = {n: t.to("cuda", dtype) for n, t in lp.items()}
        y1, a1 = moe.moe_ffn(x.to("cuda", dtype), glp, c)
        y2, a2 = moe.moe_ffn(x.to("cuda", dtype), glp, c)
        assert torch.equal(y1, y2) and torch.equal(a1, a2)
    want, aux = moe.moe_ffn(x, lp, cfg)
    torch.testing.assert_close(y1.cpu(), want, atol=1e-5, rtol=0)
    assert abs(float(a1) - float(aux)) <= 1e-6
    xg = x.reshape(8, 64, -1)
    cap = moe.capacity(64, cfg.n_experts, cfg.top_k, 0.5)
    plan, _ = moe.route(xg.cuda(), lp["router"].cuda(), cfg.n_experts,
                        cfg.top_k, cap)
    want_plan, _ = moe.route(xg, lp["router"], cfg.n_experts, cfg.top_k, cap)
    assert torch.equal(plan.row.cpu(), want_plan.row)
    assert torch.equal(plan.keep.cpu(), want_plan.keep)
    assert not plan.keep.all()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-16e"])
def test_cuda_moe_arch_decodes_without_a_sync_and_matches_the_cpu(arch):
    """Prefill and 3 x window decode steps (mixtral across its 16-slot
    ring's wrap) of the smoke config (f32) on the card and on the CPU from
    one state: logits within atol 5e-5, rtol 1e-5; a decode step runs
    under the sync debug mode "error"."""
    _cuda_or_skip()
    from repro_torch import configs, tree_map
    from repro_torch.models import transformer as T

    cfg = configs.get(arch).smoke_cfg
    cpu = T.init_params(torch.Generator("cpu").manual_seed(7), cfg,
                        device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 128)))
    torch.testing.assert_close(T.prefill(gpu, tokens.cuda(), cfg).cpu(),
                               T.prefill(cpu, tokens, cfg), atol=5e-5,
                               rtol=1e-5)
    ccache = T.init_cache(cfg, 2, 64, device="cpu")
    gcache = T.init_cache(cfg, 2, 64, device="cuda")
    n = 3 * (cfg.attn_window or cfg.attn_chunk)
    for i, tok in enumerate(tokens[:, :n].T.contiguous()):
        want, ccache = T.decode_step(cpu, ccache, tok, cfg)
        if i == n - 1:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            got, gcache = T.decode_step(gpu, gcache, tok.pin_memory(), cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.testing.assert_close(got.cpu(), want, atol=5e-5, rtol=1e-5)
    assert torch.equal(gcache["pos"].cpu(), ccache["pos"])


def _wide_case(seed, D, weighted, C=300, nnz=4000, num_bags=700):
    """Bag inputs on the CPU at width ``D`` with a very long working row
    (1500 entries), a long one (200) and short ones, out-of-range
    segments, and empty bags."""
    rng = np.random.default_rng(seed)
    working = rng.standard_normal((C + 1, D)).astype(np.float32)
    working[C] = 0.0
    inv = rng.integers(0, C + 1, nnz).astype(np.int32)
    inv[rng.permutation(nnz)[:1700]] = np.repeat([5, 7], [1500, 200])
    seg = rng.integers(-3, num_bags + 3, nnz).astype(np.int32)
    w = rng.standard_normal(nnz).astype(np.float32) if weighted else None
    return [None if x is None else torch.from_numpy(x)
            for x in (working, inv, seg, w)], num_bags


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("D", [257, 300, 513, 602, 1433])
def test_cuda_bag_wide_rows_match_plain_version(D, weighted):
    """Kernels 1 and 1b past 256 columns (column tiles of 256 on one set of
    streams; D 300 a multiple of 4, so its tiles take the float4 walk, the
    others the scalar one): the forward and the working-row gradient
    bit-equal to the CPU plain version and its vjp, two runs bit-equal,
    a working set 4 bytes off a 16-byte edge bit-equal too."""
    _cuda_or_skip()
    cpu, nb = _wide_case(11, D, weighted)
    dev = [None if x is None else x.cuda() for x in cpu]
    want = tref.embedding_bag_ref(*cpu, nb)
    got = tbag.embedding_bag_cuda(*dev, nb)
    again = tbag.embedding_bag_cuda(*dev, nb)
    off = tbag.embedding_bag_cuda(_unaligned(dev[0]), *dev[1:], nb)
    walked = tbag.walk(dev[0], *tbag.forward_streams(*dev, nb)[:3])
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (nb, D)).astype(np.float32))
    want_g, _ = tref.embedding_bag_backward_ref(g, *cpu, True, False)
    got_g, _ = tbag.embedding_bag_backward_cuda(g.cuda(), *dev, True, False)
    again_g, _ = tbag.embedding_bag_backward_cuda(g.cuda(), *dev, True,
                                                  False)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again) and torch.equal(off, got)
    assert torch.equal(walked, got)
    assert torch.equal(got_g.cpu(), want_g)
    assert torch.equal(got_g, again_g)


@pytest.mark.gpu
def test_cuda_bag_width_limit():
    """The bag takes rows up to the extension's ``max_bag_dim`` columns,
    and its binding raises past it."""
    _cuda_or_skip()
    from repro_torch.kernels.build import extension

    top_dim = extension().max_bag_dim
    inv = torch.zeros(3, dtype=torch.int32, device="cuda")
    seg = torch.tensor([0, 1, 1], dtype=torch.int32, device="cuda")
    top = torch.randn((2, top_dim), device="cuda")
    out = tbag.embedding_bag_cuda(top, inv, seg, None, 2)
    assert torch.equal(out.cpu(), tref.embedding_bag_ref(
        top.cpu(), inv.cpu(), seg.cpu(), None, 2))
    with pytest.raises(RuntimeError, match="dim must lie in"):
        tbag.embedding_bag_cuda(torch.zeros((2, top_dim + 1),
                                            device="cuda"), inv, seg, None, 2)


def _bad_bag_call(case):
    """Arguments of the forward binding that break one of its checks."""
    inv = torch.zeros(3, dtype=torch.int32, device="cuda")
    seg = torch.tensor([0, 1, 1], dtype=torch.int32, device="cuda")
    working = torch.ones((2, 4), device="cuda")
    if case == "cpu tensor":
        working = working.cpu()
    elif case == "dtype":
        inv = inv.long()
    elif case == "not contiguous":
        working = torch.ones((4, 2), device="cuda").t()
    elif case == "lengths":
        seg = seg[:2]
    elif case == "num_bags":
        return working, inv, seg, None, 0
    return working, inv, seg, None, 2


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cpu tensor", "dtype", "not contiguous",
                                  "lengths", "num_bags"])
def test_cuda_binding_check_raises(case):
    """A check that fails inside the extension raises RuntimeError (and
    the process goes on: a good call after it still runs)."""
    _cuda_or_skip()
    from repro_torch.kernels.build import extension

    ext = extension()
    with pytest.raises(RuntimeError):
        ext.embedding_bag_forward(*_bad_bag_call(case), False)
    working, inv, seg, _, _ = _bad_bag_call("good")
    out, = ext.embedding_bag_forward(working, inv, seg, None, 2, False)
    assert out.sum().item() == 12.0


# ---- the pull prefetch (A5) on the card: the plan on a side stream, the
# table part on the main stream after the step
def _prefetch_trainer(placement, store, prefetch, spill):
    from repro_torch.core.kstep import KStepConfig
    from repro_torch.core.sparse_optim import SparseAdagradConfig
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.trainer import TrainerConfig

    disk = store == "disk"
    tcfg = TrainerConfig(
        n_pod=2, kstep=KStepConfig(lr=1e-3, k=3),
        sparse=SparseAdagradConfig(lr=0.5, initial_accumulator=0.01),
        placement=placement, capacity=512,
        cache_rows=512 if placement == "cached" else None, store=store,
        spill_dir=spill if disk else None, page_rows=256 if disk else None,
        page_cache_pages=8 if disk else None, prefetch=prefetch, log_every=2)
    return build_trainer("baidu-ctr", tcfg, seed=2, device="cuda")


def _sparse_rows(tr):
    """The trained rows and accumulators from the authoritative tier."""
    eng = tr.engine
    if eng.store.kind == "disk":
        eng.sync_store(tr.tables, tr.sparse_state.accum, tr.backend_state)
        return [torch.from_numpy(x.copy()) for n, s in eng.specs.items()
                for x in eng.store.gather(n, np.arange(s.rows))]
    t, a, _ = eng.flush(tr.tables, tr.sparse_state.accum, tr.backend_state)
    return [x.cpu() for x in list(t.values()) + list(a.values())]


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["host", "disk"])
@pytest.mark.parametrize("placement", ["gather", "cached"])
def test_cuda_prefetched_fit_is_the_synchronous_fit(placement, store,
                                                    tmp_path):
    """Smoke size on the card: a prefetched ``fit`` (one batch ahead, the
    plan on the side stream) against the synchronous one, losses, history,
    dense tree, rows and accumulators bit-equal, and the same launch counts
    (prefetch adds no kernel and drops none)."""
    _cuda_or_skip()
    from repro_torch.configs import baidu_ctr
    from repro_torch.data.synthetic import recsys_batches

    gen = recsys_batches(baidu_ctr.SMOKE, batch=64, seed=1)
    batches = [next(gen) for _ in range(7)]
    out = []
    for prefetch in (False, True):
        tr = _prefetch_trainer(placement, store, prefetch,
                               str(tmp_path / f"spill{int(prefetch)}"))
        ops.reset_launches()
        hist = tr.fit(iter(batches), 7)
        torch.cuda.synchronize()
        launches = dict(ops.launches)
        dense = [x.detach().cpu() for x in _tree_leaves(tr.dense)]
        out.append((hist, launches, dense, _sparse_rows(tr)))
        tr.close()
    (ha, la, da, ra), (hb, lb, db, rb) = out
    skip = {"sec", "page_hit_rate", "pages_evicted", "disk_bytes_read",
            "disk_bytes_written"}
    skip |= {f"{k}_total" for k in skip}
    assert [{k: v for k, v in r.items() if k not in skip} for r in ha] == \
        [{k: v for k, v in r.items() if k not in skip} for r in hb]
    assert la == lb and all(v == 0 for k, v in lb.items()
                            if k.endswith("_ref"))
    assert all(torch.equal(x, y) for x, y in zip(da + ra, db + rb))


def _tree_leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [x for v in vals for x in _tree_leaves(v)]


@pytest.mark.gpu
def test_cuda_prefetch_plan_does_not_wait_for_the_main_stream():
    """With ``torch.cuda._sleep`` queued on the main stream, ``prefetch(b)``
    on the gather placement returns while an event recorded after the sleep
    is still pending: the plan's host size reads wait for the side stream
    only.  The step trained on that pull equals the synchronous one."""
    _cuda_or_skip()
    from repro_torch.configs import baidu_ctr
    from repro_torch.data.synthetic import recsys_batches

    gen = recsys_batches(baidu_ctr.SMOKE, batch=64, seed=1)
    b1, b2, b3 = (next(gen) for _ in range(3))
    pre = _prefetch_trainer("gather", "host", True, None)
    sync = _prefetch_trainer("gather", "host", False, None)
    for b in (b1, b2):       # warm: the kernels built, the pools populated
        pre.train_step(b)
        sync.train_step(b)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)      # ~1 s of the main stream
    after = torch.cuda.Event()
    after.record()
    assert pre.prefetch(b3)
    pending = not after.query()
    got = pre.train_step(b3)
    want = sync.train_step(b3)
    torch.cuda.synchronize()
    assert pending, "prefetch waited for the main stream"
    assert torch.equal(got, want)
    assert torch.equal(pre.tables["sparse"], sync.tables["sparse"])
    assert torch.equal(pre.sparse_state.accum["sparse"],
                       sync.sparse_state.accum["sparse"])


@pytest.mark.gpu
def test_cuda_pipeline_stager_feeds_a_prefetched_fit():
    """``CudaStager`` copies each batch on its own stream in the producer
    thread; a prefetched ``fit`` fed by the pipeline equals a directly fed
    synchronous one bit for bit."""
    _cuda_or_skip()
    from repro_torch.configs import baidu_ctr
    from repro_torch.data.pipeline import (CudaStager, PrefetchPipeline,
                                           StagedBatch)
    from repro_torch.data.synthetic import recsys_batches

    gen = recsys_batches(baidu_ctr.SMOKE, batch=64, seed=1)
    batches = [next(gen) for _ in range(6)]
    sync = _prefetch_trainer("cached", "host", False, None)
    hs = sync.fit(iter(batches), 6)
    pre = _prefetch_trainer("cached", "host", True, None)
    pipe = PrefetchPipeline(iter(batches), depth=2, stage_fn=CudaStager())
    first = next(pipe)
    assert isinstance(first, StagedBatch) and first.ready is not None
    assert first["ids"].is_cuda
    hp = pre.fit(_chain(first, pipe), 6)
    pipe.close()
    assert [r["loss"] for r in hs] == [r["loss"] for r in hp]
    for x, y in zip(_sparse_rows(sync), _sparse_rows(pre)):
        assert torch.equal(x, y)


def _chain(first, rest):
    yield first
    yield from rest
