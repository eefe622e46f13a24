"""The port's kernels' plain versions and dispatch (``repro_torch.kernels``)
against the reference: the embedding bag, the push's row math (bit-equal)
and the cache tier's cached gather and cached push (exact).

On the CPU the port runs the plain PyTorch version; it is held against the
reference's jnp oracle and against the Pallas kernel itself
(``embedding_bag_pallas(..., interpret=True, exact=True)``), on the same
numpy inputs: unsorted segments, weights on and off, drop-row entries and
empty bags, all three combiners.  Tolerance atol = rtol = 1e-6 (float32
sums of at most a few dozen terms, added in the same order on both sides).

The CUDA kernel itself runs only on the card (``test_torch_gpu.py``).  What
surrounds its launch (the CSR index preparation, the checks, the autograd
wiring) is tested here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sparse_adagrad as tsa
from tests.test_torch_gpu import (
    BAG_SIZES,
    _bags_case,
    _rows_case,
    plain_streams,
)

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)

# (capacity, dim, nnz, num_bags): the last two leave bags empty
SHAPES = [(37, 16, 101, 19), (64, 24, 40, 53), (200, 64, 300, 120)]


def _case(seed, C, D, nnz, num_bags, weighted=True):
    """Working set (C + 1, D) whose last row is the zero drop row; inv hits
    it now and then; seg is unsorted and misses some bags."""
    rng = np.random.default_rng(seed)
    working = rng.standard_normal((C + 1, D)).astype(np.float32)
    working[C] = 0.0
    inv = rng.integers(0, C, nnz).astype(np.int32)
    inv[rng.random(nnz) < 0.1] = C
    used = rng.choice(num_bags, size=max(1, num_bags * 2 // 3), replace=False)
    seg = rng.choice(used, size=nnz).astype(np.int32)
    w = (rng.random(nnz) < 0.9).astype(np.float32) if weighted else None
    return working, inv, seg, w


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bag_ref_matches_reference_oracle(shape, weighted):
    working, inv, seg, w = _case(0, *shape, weighted=weighted)
    num_bags = shape[3]
    got = tref.embedding_bag_ref(_t(working), _t(inv), _t(seg), _t(w),
                                 num_bags).numpy()
    want = np.asarray(jref.embedding_bag_ref(_j(working), _j(inv), _j(seg),
                                             _j(w), num_bags))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bag_ref_matches_pallas_kernel(shape, weighted):
    working, inv, seg, w = _case(1, *shape, weighted=weighted)
    num_bags = shape[3]
    got = tref.embedding_bag_ref(_t(working), _t(inv), _t(seg), _t(w),
                                 num_bags).numpy()
    want = np.asarray(embedding_bag_pallas(
        _j(working), _j(inv), _j(seg), _j(w), num_bags,
        interpret=True, exact=True))
    np.testing.assert_allclose(got, want, **TOL)
    empty = np.setdiff1d(np.arange(num_bags), seg)
    assert empty.size and not got[empty].any()


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_combiner_ref_matches_reference_oracle(combiner):
    working, inv, seg, w = _case(2, *SHAPES[0])
    num_bags = SHAPES[0][3]
    got = ops.embedding_bag_working(_t(working), _t(inv), _t(seg), _t(w),
                                    num_bags, combiner).numpy()
    want = np.asarray(jref.embedding_bag_combiner_ref(
        _j(working), _j(inv), _j(seg), _j(w), num_bags, combiner))
    np.testing.assert_allclose(got, want, **TOL)
    denom = tref.bag_combiner_denom_ref(_t(seg), num_bags, combiner,
                                        torch.float32).numpy()
    np.testing.assert_allclose(denom, np.asarray(jref.bag_combiner_denom_ref(
        _j(seg), num_bags, combiner, jnp.float32)), **TOL)


def test_out_of_range_segments_are_dropped():
    working, inv, seg, w = _case(3, *SHAPES[0])
    num_bags = SHAPES[0][3]
    seg[:5] = -1
    seg[5:9] = num_bags + 3
    got = tref.embedding_bag_ref(_t(working), _t(inv), _t(seg), _t(w),
                                 num_bags).numpy()
    want = np.asarray(jref.embedding_bag_ref(_j(working), _j(inv), _j(seg),
                                             _j(w), num_bags))
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_dispatch_runs_the_plain_version_and_counts_it():
    working, inv, seg, w = _case(4, *SHAPES[1])
    ops.reset_launches()
    assert ops.kernel_mode(_t(working)) == "ref"
    out = ops.embedding_bag_working(_t(working), _t(inv), _t(seg), _t(w),
                                    SHAPES[1][3])
    assert ops.launches == {
        "embedding_bag": 0, "embedding_bag_ref": 1,
        "embedding_bag_backward": 0, "embedding_bag_backward_ref": 0,
        "sparse_adagrad_apply": 0, "sparse_adagrad_apply_ref": 0,
        "hash_lookup": 0, "hash_lookup_ref": 0,
        "gather_rows_cached": 0, "gather_rows_cached_ref": 0,
        "sparse_adagrad_cached_apply": 0,
        "sparse_adagrad_cached_apply_ref": 0,
        "sparse_adagrad": 0, "sparse_adagrad_ref": 0,
        "fused_adam": 0, "fused_adam_ref": 0,
        "dot_interaction": 0, "dot_interaction_ref": 0,
        "dot_interaction_backward": 0, "dot_interaction_backward_ref": 0,
        "flash_attention": 0, "flash_attention_ref": 0,
        "flash_attention_window": 0, "flash_attention_chunk": 0,
        "flash_attention_backward": 0, "flash_attention_backward_ref": 0,
        "flash_attention_backward_window": 0,
        "flash_attention_backward_chunk": 0}
    np.testing.assert_array_equal(
        out.numpy(), tref.embedding_bag_ref(_t(working), _t(inv), _t(seg),
                                            _t(w), SHAPES[1][3]).numpy())
    with pytest.raises(ValueError, match="unknown combiner"):
        ops.embedding_bag_working(_t(working), _t(inv), _t(seg), _t(w),
                                  SHAPES[1][3], "max")


def test_resolve_fused():
    assert ops.resolve_fused(None, "cpu") is False
    assert ops.resolve_fused(True, "cpu") is True
    assert ops.resolve_fused(None, "cuda") is True
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_fused(False, "cuda")


def test_cuda_wrapper_raises_on_what_it_does_not_take():
    working, inv, seg, w = _case(5, *SHAPES[0])
    args = [_t(working), _t(inv), _t(seg), _t(w), SHAPES[0][3]]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbag.embedding_bag_cuda(*args)
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError, match="int32"):
        tbag.embedding_bag_cuda(*bad)
    bad = list(args)
    bad[3] = bad[3][:-1]
    with pytest.raises(ValueError, match="weights"):
        tbag.embedding_bag_cuda(*bad)
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(ValueError, match="float32"):
        tbag.embedding_bag_cuda(*bad)


def _sum_in_csr_order(src, idx_sorted, w_sorted, offsets):
    """The kernel's arithmetic, one output row at a time, on the streams
    the wrapper launches it with: float32 adds of the row's entries in
    stream order, each term rounded after its multiply (no fused
    multiply-add)."""
    src, idx = src.numpy(), idx_sorted.numpy()
    w = None if w_sorted is None else w_sorted.numpy()
    offsets = offsets.numpy()
    out = np.zeros((len(offsets) - 1, src.shape[1]), np.float32)
    for b in range(len(offsets) - 1):
        acc = np.zeros(src.shape[1], np.float32)
        for i in range(offsets[b], offsets[b + 1]):
            x = src[idx[i]]
            if w is not None:
                x = (x * w[i]).astype(np.float32)
            acc = (acc + x).astype(np.float32)
        out[b] = acc
    return out


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_csr_order_gives_the_plain_sums_bit_for_bit(shape, weighted):
    """The index preparation the CUDA wrapper launches with: each bag's
    entries in ascending original position, out-of-range segments in no
    bag.  Summed in that order they equal the plain version's bits."""
    working, inv, seg, w = _case(6, *shape, weighted=weighted)
    num_bags = shape[3]
    seg[:3] = num_bags + 1
    order, offsets = tbag.csr_from_segments(_t(seg), num_bags)
    order, offsets = order.numpy(), offsets.numpy()
    assert offsets[0] == 0 and offsets[-1] == len(seg) - 3
    for b in range(num_bags):
        ent = order[offsets[b]:offsets[b + 1]]
        np.testing.assert_array_equal(ent, np.flatnonzero(seg == b))
    ow = None if w is None else _t(w[order])
    got = _sum_in_csr_order(_t(working), _t(inv[order]), ow,
                            torch.from_numpy(offsets))
    want = tref.embedding_bag_ref(_t(working), _t(inv), _t(seg), _t(w),
                                  num_bags).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad_seg", [False, True])
@pytest.mark.parametrize("weighted", [True, False])
def test_forward_streams_plain_version(weighted, bad_seg):
    """The forward's index streams by their plain version (a stable sort by
    seg, out-of-range bags last: what the CUDA streams are held to) agree
    with ``csr_from_segments`` on every bag (0 to 129 entries), and the
    walk's arithmetic over them gives the plain version's bits."""
    working, inv, seg, w = _bags_case(7, 24, BAG_SIZES, weighted, bad_seg)
    nb = len(BAG_SIZES)
    inv_s, w_s, offsets, seg_s = plain_streams(seg, nb, inv, w)[:4]
    order, csr = tbag.csr_from_segments(seg, nb)
    lo, hi = int(csr[0]), int(csr[-1])
    assert torch.equal(offsets, csr - lo)
    assert torch.equal(inv_s[:hi - lo], inv[order[lo:hi]])
    assert torch.equal(seg_s[hi - lo:], torch.full((len(seg) - hi + lo,), nb,
                                                   dtype=torch.int32))
    got = _sum_in_csr_order(working, inv_s, w_s, offsets)
    want = tref.embedding_bag_ref(working, inv, seg, w, nb).numpy()
    np.testing.assert_array_equal(got, want)


# columns a long-row block of the backward kernel adds (kSlice in
# csrc/embedding_bag.cu); a slice's columns add independently of the rest
SLICE = 8


def _rows_in_kernel_order(g, seg_sorted, w_sorted, offsets, keys_sorted,
                          row_lists):
    """The working-row gradient kernel's split and arithmetic on CPU
    tensors: ``(g_work, writes)``.  g_work starts as zeros (the memset
    writes every row once); the rows on the long-row list are added SLICE
    columns at a time, the very long ones first, and those on the short-row
    list all columns at once.  Both add the row's entries in stream order,
    each term rounded after its multiply (no fused multiply-add), an entry
    whose segment lies outside g adding a zero.  ``writes[r]`` counts the
    times row r was written: the memset for a row without entries, its
    adds for the others."""
    gn, seg, off = g.numpy(), seg_sorted.numpy(), offsets.numpy()
    w = None if w_sorted is None else w_sorted.numpy()
    lst = row_lists.numpy()
    n_very, n_long, long_row, n_short = lst[:4]
    room = (len(lst) - 4) - len(seg)
    rows, D = len(off) - 1, gn.shape[1]
    out = np.zeros((rows, D), np.float32)
    writes = (off[1:] == off[:-1]).astype(np.int64)

    def walk(r, cols):
        acc = np.zeros(len(cols), np.float32)
        for i in range(off[r], off[r + 1]):
            b = seg[i]
            x = (gn[b, cols] if 0 <= b < gn.shape[0]
                 else np.zeros(len(cols), np.float32))
            if w is not None:
                x = (x * w[i]).astype(np.float32)
            acc = (acc + x).astype(np.float32)
        out[r, cols] = acc

    for q in range(n_very + n_long):
        r = lst[4 + (q if q < n_very else room - 1 - (q - n_very))]
        assert off[r + 1] - off[r] > long_row
        for c0 in range(0, D, SLICE):
            walk(r, np.arange(c0, min(c0 + SLICE, D)))
        writes[r] += 1
    for q in range(n_short):
        r = lst[4 + room + q]
        assert 0 < off[r + 1] - off[r] <= long_row
        walk(r, np.arange(D))
        writes[r] += 1
    return torch.from_numpy(out), writes


def _backward_in_csr_order(g, working, inv, seg, w, need_working,
                           need_weights, long_row=tbag.LONG_ROW):
    """The backward kernels' arithmetic on CPU tensors: the working-row
    gradient on the streams the CUDA wrapper launches it with (their plain
    version, ``plain_streams``), split into long and short rows as the
    kernels split them, each row written once; the weight gradient sums
    each dot product per lane (columns l, l + 32, ...) and then over a
    fixed shuffle tree, as the kernel does."""
    gn = g.numpy()
    g_work = g_w = None
    if need_working:
        g_work, writes = _rows_in_kernel_order(
            g, *plain_streams(inv, working.shape[0], seg, w, long_row))
        assert (writes == 1).all()
    if need_weights:
        wk, iv, sg = working.numpy(), inv.numpy(), seg.numpy()
        D = wk.shape[1]
        out = np.zeros(len(sg), np.float32)
        for j in range(len(sg)):
            lanes = np.zeros(32, np.float32)
            for c in range(D):
                p = np.float32(gn[sg[j], c] * wk[iv[j], c])
                lanes[c % 32] = np.float32(lanes[c % 32] + p)
            off = 16
            while off:
                lanes[:off] = (lanes[:off] + lanes[off:2 * off]).astype(
                    np.float32)
                off //= 2
            out[j] = lanes[0]
        g_w = torch.from_numpy(out)
    return g_work, g_w


@pytest.mark.parametrize("long_row", [tbag.LONG_ROW, 2])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_csr_by_inv_order_gives_the_plain_vjp_bit_for_bit(shape, weighted,
                                                         long_row):
    """The backward's index preparation (a stable sort of inv, every working
    row written, the drop row and untouched rows as zeros) and the kernel's
    split into long and short rows (``long_row`` 2 makes most touched rows
    long here): summed in that order, the working-row gradient equals the
    plain vjp's bits, and each row is written once."""
    working, inv, seg, w = _case(9, *shape, weighted=weighted)
    num_bags = shape[3]
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (num_bags, shape[1])).astype(np.float32))
    got, _ = _backward_in_csr_order(g, _t(working), _t(inv), _t(seg), _t(w),
                                    True, False, long_row)
    want, _ = tref.embedding_bag_backward_ref(g, _t(working), _t(inv),
                                              _t(seg), _t(w))
    assert got.shape == (shape[0] + 1, shape[1])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    untouched = np.setdiff1d(np.arange(shape[0] + 1), inv)
    assert not got.numpy()[untouched].any()


# (dim, rows' entry counts, long_row): rows of exactly T - 1, T and T + 1
# entries around a small threshold and the kernel's (LONG_ROW and
# VERY_LONG), one row holding every entry, a hot row of phase 1's 4130
# entries beside Zipf-like others
ROW_LAYOUTS = {
    "edges_t8": (24, [7, 8, 9, 0, 1, 17, 3], 8),
    "edges": (16, [tbag.LONG_ROW - 1, tbag.LONG_ROW, tbag.LONG_ROW + 1, 2,
                   0, 5, tbag.VERY_LONG, tbag.VERY_LONG + 1], tbag.LONG_ROW),
    "one_row": (40, [0, 0, 300, 0], 8),
    "one_row_long": (16, [0, 1600, 0], tbag.LONG_ROW),
    "hot": (20, [4130, 700, 300, 129, 33, 32, 3, 1, 0], tbag.LONG_ROW),
}


@pytest.mark.parametrize("bad_seg", [False, True])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("layout", sorted(ROW_LAYOUTS))
def test_long_and_short_rows_give_the_plain_vjp_bit_for_bit(layout,
                                                            weighted,
                                                            bad_seg):
    """The kernel's split at the edges of the long-row threshold and with a
    single or a hot long row: exactly the rows of more than ``long_row``
    entries are long, each row is written once, and the working-row
    gradient equals the plain vjp's bits, out-of-range segments adding
    zeros."""
    D, counts, long_row = ROW_LAYOUTS[layout]
    g, working, inv, seg, w = _rows_case(13, D, counts, 50, weighted,
                                         bad_seg)
    lst = plain_streams(inv, working.shape[0], seg, w, long_row)[4].numpy()
    n_very, n_long, _, n_short = lst[:4]
    room = len(lst) - 4 - len(inv)
    assert lst[2] == long_row and room == len(inv) // (long_row + 1)
    very = list(lst[4:4 + n_very])
    other = list(lst[4 + room - n_long:4 + room][::-1])
    short = list(lst[4 + room:4 + room + n_short])
    assert very == [r for r, n in enumerate(counts) if n > tbag.VERY_LONG]
    assert other == [r for r, n in enumerate(counts)
                     if long_row < n <= tbag.VERY_LONG]
    assert short == [r for r, n in enumerate(counts) if 0 < n <= long_row]
    got, _ = _backward_in_csr_order(g, working, inv, seg, w, True, False,
                                    long_row)
    want, _ = tref.embedding_bag_backward_ref(g, working, inv, seg, w)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sorted_streams_plain_version():
    """The backward's index streams on CPU tensors: a stable order by key,
    keys outside [0, num_rows) read num_rows and sort last, the offsets
    bound each row's entries, seg and the weights follow the order, and the
    row lists name the long and the short rows."""
    keys = torch.tensor([3, -1, 0, 3, 7, 0, 2, 9, 3], dtype=torch.int32)
    seg = torch.arange(9, dtype=torch.int32) * 10
    w = torch.arange(9, dtype=torch.float32) / 4
    seg_s, w_s, off, keys_s, lst = plain_streams(keys, 4, seg, w, 1)
    order = [2, 5, 6, 0, 3, 8, 1, 4, 7]
    assert keys_s.tolist() == [0, 0, 2, 3, 3, 3, 4, 4, 4]
    assert seg_s.tolist() == [10 * j for j in order]
    assert w_s.tolist() == [j / 4 for j in order]
    assert off.dtype == torch.int64 and off.tolist() == [0, 2, 2, 3, 6]
    # rows 0 and 3 hold more than 1 entry (room for 9 // 2 = 4), row 2 one
    assert lst.dtype == torch.int32
    assert lst.tolist() == [0, 2, 1, 1, 0, 0, 3, 0, 2] + [0] * 8
    assert plain_streams(keys, 4, seg, None)[1] is None


def test_autograd_backward_is_the_plain_vjp(monkeypatch):
    """The autograd.Function, with CPU emulations of the CUDA kernels
    standing in for their launches (which exist only on the card): the
    working-row gradient equals the plain vjp bit for bit, the weight
    gradient within atol = rtol = 1e-6 (the plain version sums each dot
    product in another order), and the launches are counted."""
    working, inv, seg, w = _case(7, *SHAPES[2])
    num_bags = SHAPES[2][3]
    monkeypatch.setattr(ops, "embedding_bag_cuda", tref.embedding_bag_ref)
    monkeypatch.setattr(ops, "embedding_bag_backward_cuda",
                        _backward_in_csr_order)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (num_bags, working.shape[1])).astype(np.float32))

    def grads(fn):
        wk = _t(working).clone().requires_grad_(True)
        ww = _t(w).clone().requires_grad_(True)
        (fn(wk, ww) * g).sum().backward()
        return wk.grad, ww.grad

    ops.reset_launches()
    got = grads(lambda wk, ww: ops._Bag.apply(wk, _t(inv), _t(seg), ww,
                                              num_bags))
    assert ops.launches["embedding_bag"] == 1
    assert ops.launches["embedding_bag_backward"] == 1
    want = grads(lambda wk, ww: tref.embedding_bag_ref(wk, _t(inv), _t(seg),
                                                       ww, num_bags))
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), **TOL)


def test_cpu_backward_runs_the_plain_vjp_and_counts_it():
    working, inv, seg, w = _case(11, *SHAPES[1])
    num_bags = SHAPES[1][3]
    wk = _t(working).clone().requires_grad_(True)
    ops.reset_launches()
    out = ops.embedding_bag_working(wk, _t(inv), _t(seg), _t(w), num_bags,
                                    "mean")
    g = torch.ones_like(out)
    (out * g).sum().backward()
    assert ops.launches["embedding_bag_ref"] == 1
    assert ops.launches["embedding_bag_backward_ref"] == 1
    assert ops.launches["embedding_bag_backward"] == 0
    x = _t(working).clone().requires_grad_(True)
    ref_out = tref.embedding_bag_combiner_ref(x, _t(inv), _t(seg), _t(w),
                                              num_bags, "mean")
    (ref_out * g).sum().backward()
    np.testing.assert_array_equal(wk.grad.numpy(), x.grad.numpy())


def test_backward_wrapper_raises_on_cpu_tensors():
    working, inv, seg, w = _case(12, *SHAPES[0])
    g = torch.zeros((SHAPES[0][3], SHAPES[0][1]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbag.embedding_bag_backward_cuda(g, _t(working), _t(inv), _t(seg),
                                         _t(w))
    with pytest.raises(ValueError, match="g must be"):
        tbag.embedding_bag_backward_cuda(g[:, :-1], _t(working), _t(inv),
                                         _t(seg), _t(w))


# ------------------------------------------- the push's row math (bit-equal)
@pytest.mark.parametrize("lr", [0.05, 0.5])
def test_row_updates_bit_equal_to_reference_on_a_million_elements(lr):
    """``adagrad_row_updates``: ``delta`` and ``g2`` bit-equal to the
    reference's under ``jax.jit`` on 2^20 elements, with gradient scales
    from 1e-3 to 10 and accumulators from 1e-2 to 100 (tolerance: none).
    The port rounds ``a + g^2`` once and takes a correctly rounded root,
    as XLA does there."""
    import jax

    from repro.kernels.sparse_adagrad import adagrad_row_updates as jrows
    from repro_torch.kernels.sparse_adagrad import adagrad_row_updates

    rng = np.random.default_rng(int(lr * 100))
    rows = (1 << 20) // 64
    g = (rng.standard_normal((rows, 64))
         * 10.0 ** rng.uniform(-3, 1, (rows, 1))).astype(np.float32)
    a = (rng.random((rows, 64)) * 10.0 ** rng.uniform(-2, 2, (rows, 1))
         + 0.01).astype(np.float32)
    jd, jg = jax.jit(lambda r, x: jrows(r, x, jnp.float32, lr=lr,
                                        eps=1e-10))(a, g)
    d, g2 = adagrad_row_updates(torch.from_numpy(a), torch.from_numpy(g),
                                torch.float32, lr=lr, eps=1e-10)
    assert d.numel() == 1 << 20
    np.testing.assert_array_equal(d.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))
    np.testing.assert_array_equal(g2.numpy().view(np.int32),
                                  np.asarray(jg).view(np.int32))


# ------------------------------------------------ the cache tier's kernels
def test_cached_ops_on_the_cpu_run_the_plain_versions_and_count_them():
    """ops.gather_rows_cached and ops.sparse_adagrad_cached_apply on CPU
    tensors: the plain versions, counted, equal to the reference's jnp
    oracle and its Pallas kernels in interpret mode (exact: the gather
    copies, the push adds the same bits)."""
    from repro.kernels.sparse_adagrad import (
        gather_rows_cached_pallas,
        sparse_adagrad_cached_apply_pallas,
    )

    rng = np.random.default_rng(7)
    C, D = 40, 16
    rows = rng.standard_normal((C, D)).astype(np.float32)
    accum = (rng.random((C, D)) + 0.01).astype(np.float32)
    uids = np.r_[np.sort(rng.choice(1000, 25, replace=False)),
                 np.zeros(7)].astype(np.int32)
    uids[25:] = uids[0]                                  # the pads
    slots = np.r_[rng.permutation(C)[:25], np.zeros(7)].astype(np.int32)
    slots[25:] = slots[0]
    grads = rng.standard_normal((32, D)).astype(np.float32)
    grads[25:] = 0.0
    ops.reset_launches()
    got = ops.gather_rows_cached(_t(rows), _t(slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        gather_rows_cached_pallas(_j(rows), _j(slots), interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.gather_rows_cached_ref(_j(rows), _j(slots))))
    r, a = _t(rows.copy()), _t(accum.copy())
    out = ops.sparse_adagrad_cached_apply(r, a, _t(slots), _t(grads),
                                          lr=0.5, eps=1e-10)
    assert out[0] is r and out[1] is a                   # in place
    jd, jg2 = _jit_rows(accum[slots], grads)
    jr, ja = sparse_adagrad_cached_apply_pallas(
        _j(rows), _j(accum), _j(slots), jd, jg2, interpret=True)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert ops.launches == {
        "embedding_bag": 0, "embedding_bag_ref": 0,
        "embedding_bag_backward": 0, "embedding_bag_backward_ref": 0,
        "sparse_adagrad_apply": 0, "sparse_adagrad_apply_ref": 0,
        "hash_lookup": 0, "hash_lookup_ref": 0,
        "gather_rows_cached": 0, "gather_rows_cached_ref": 2,
        "sparse_adagrad_cached_apply": 0,
        "sparse_adagrad_cached_apply_ref": 1,
        "sparse_adagrad": 0, "sparse_adagrad_ref": 0,
        "fused_adam": 0, "fused_adam_ref": 0,
        "dot_interaction": 0, "dot_interaction_ref": 0,
        "dot_interaction_backward": 0, "dot_interaction_backward_ref": 0,
        "flash_attention": 0, "flash_attention_ref": 0,
        "flash_attention_window": 0, "flash_attention_chunk": 0,
        "flash_attention_backward": 0, "flash_attention_backward_ref": 0,
        "flash_attention_backward_window": 0,
        "flash_attention_backward_chunk": 0}
    for fn, args, kw in (
            (tsa.gather_rows_cached_cuda, (_t(rows), _t(slots)), {}),
            (tsa.gather_rows_cached_cuda, (_t(rows), _t(slots)),
             dict(drop_row=True)),
            (tsa.sparse_adagrad_cached_apply_cuda,
             (_t(rows), _t(accum), _t(slots), _t(uids), _t(grads)),
             dict(lr=0.5, eps=1e-10)),
            (tsa.sparse_adagrad_apply_cuda,
             (_t(rows), _t(accum), _t(uids), _t(grads)),
             dict(lr=0.5, eps=1e-10))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, **kw)


def _jit_rows(accum_rows, grads):
    """The reference's row math, jitted as its train step runs it."""
    import jax

    from repro.kernels.sparse_adagrad import adagrad_row_updates as jrows

    return jax.jit(lambda r, g: jrows(r, g, jnp.float32, lr=0.5,
                                      eps=1e-10))(accum_rows, grads)


# ------------------------------------- the staged push and the local Adam
@pytest.mark.parametrize("C,D,n_real", [(96, 64, 70), (50, 16, 50),
                                        (33, 3, 20)])
def test_staged_push_plain_version_matches_pallas_and_the_host_push(
        C, D, n_real):
    """Kernel 7's plain version (``ref.sparse_adagrad_ref``, the CPU path):
    within rtol 1e-6 (atol 1e-7 for values crossing zero) of the reference's
    ``sparse_adagrad_pallas(interpret=True)``, and bit-equal at every real
    position to the port's host push on a resident table (the same
    ``adagrad_row_updates`` bits, then one add); pads (zero gradients)
    unchanged."""
    from repro.kernels.sparse_adagrad import sparse_adagrad_pallas

    rng = np.random.default_rng(C + D)
    table = rng.standard_normal((400, D)).astype(np.float32)
    accum = (rng.random((400, D)) + 0.01).astype(np.float32)
    real = np.sort(rng.choice(400, n_real, replace=False)).astype(np.int32)
    uids = np.r_[real, np.full(C - n_real, real[0])].astype(np.int32)
    grads = rng.standard_normal((C, D)).astype(np.float32)
    grads[n_real:] = 0.0
    rows, acc = _t(table[uids].copy()), _t(accum[uids].copy())
    ops.reset_launches()
    out = ops.sparse_adagrad(rows, acc, _t(grads), lr=0.5, eps=1e-10)
    assert out[0] is rows and out[1] is acc            # in place
    assert ops.launches["sparse_adagrad_ref"] == 1
    jw, ja = sparse_adagrad_pallas(_j(table[uids]), _j(accum[uids]),
                                   _j(grads), lr=0.5, eps=1e-10,
                                   interpret=True)
    np.testing.assert_allclose(rows.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ja), rtol=1e-6)
    t, a = _t(table.copy()), _t(accum.copy())
    ops.sparse_adagrad_apply(t, a, _t(uids), _t(grads), lr=0.5, eps=1e-10)
    np.testing.assert_array_equal(rows.numpy()[:n_real], t.numpy()[real])
    np.testing.assert_array_equal(acc.numpy()[:n_real], a.numpy()[real])
    np.testing.assert_array_equal(rows.numpy()[n_real:],
                                  table[uids[n_real:]])
    with pytest.raises(ValueError, match="CUDA"):
        tsa.sparse_adagrad_staged_cuda(rows, acc, _t(grads), lr=0.5,
                                       eps=1e-10)


def test_fused_adam_plain_version_matches_pallas():
    """Kernel 6's plain version on the step ``fused_adam_pallas`` computes
    (no warm-up, no bias correction, no weight decay), within 1e-6 of
    ``fused_adam_pallas(interpret=True)`` leaf by leaf; counted once for
    all leaves."""
    from repro.kernels.fused_adam import fused_adam_pallas

    rng = np.random.default_rng(12)
    sizes = (300, 1, 4097)
    draw = lambda s, pos=False: [
        (np.abs(x) + 1e-3 if pos else x).astype(np.float32)
        for x in (rng.standard_normal(n) * s for n in sizes)]
    p, g, m, v, vh = draw(0.3), draw(0.01), draw(0.01), draw(1e-4, True), \
        draw(1e-4, True)
    got = [[_t(x.copy()) for x in grp] for grp in (p, g, m, v, vh)]
    ops.reset_launches()
    ops.fused_adam(*got, t=torch.tensor(5, dtype=torch.int32), lr=1e-3,
                   b1=0.0, b2=0.999, k=20, local_v_warmup=False)
    assert ops.launches["fused_adam_ref"] == 1
    for i in range(len(sizes)):
        want = fused_adam_pallas(_j(p[i]), _j(g[i]), _j(m[i]), _j(v[i]),
                                 _j(vh[i]), lr=1e-3, b1=0.0, b2=0.999,
                                 interpret=True)
        for leaf, w in zip((got[0][i], got[2][i], got[3][i]), want):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6)


def test_fused_adam_cuda_wrapper_rejects_cpu_leaves():
    from repro_torch.kernels.fused_adam import AdamTable, fused_adam_cuda

    leaves = [[torch.zeros(3)] for _ in range(5)]
    with pytest.raises(ValueError, match="CUDA"):
        AdamTable().get(leaves[0], leaves[2], leaves[3], leaves[4])
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam_cuda(*leaves, t=torch.tensor(1, dtype=torch.int32),
                        lr=1e-3, b1=0.0, b2=0.999, k=2, local_v_warmup=True)
