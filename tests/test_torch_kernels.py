"""The port's embedding bag (``repro_torch.kernels``) against the reference.

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
        "sparse_adagrad_apply": 0, "sparse_adagrad_apply_ref": 0}
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


def _backward_in_csr_order(g, working, inv, seg, w, need_working,
                           need_weights):
    """The backward kernels' arithmetic on CPU tensors: the working-row
    gradient is the forward's walk with the roles of inv and seg swapped,
    over the CSR by inv that the CUDA wrapper builds; the weight gradient
    sums each dot product per lane (columns l, l + 32, ...) and then over a
    fixed shuffle tree, as the kernel does."""
    gn = g.numpy()
    g_work = g_w = None
    if need_working:
        g_work = torch.from_numpy(_sum_in_csr_order(
            g, *tbag.sorted_streams(inv, working.shape[0], seg, w)))
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


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_csr_by_inv_order_gives_the_plain_vjp_bit_for_bit(shape, weighted):
    """The backward's index preparation (a stable sort of inv, every working
    row written, the drop row and untouched rows as zeros): summed in that
    order, the working-row gradient equals the plain vjp's bits."""
    working, inv, seg, w = _case(9, *shape, weighted=weighted)
    num_bags = shape[3]
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (num_bags, shape[1])).astype(np.float32))
    got, _ = _backward_in_csr_order(g, _t(working), _t(inv), _t(seg), _t(w),
                                    True, False)
    want, _ = tref.embedding_bag_backward_ref(g, _t(working), _t(inv),
                                              _t(seg), _t(w))
    assert got.shape == (shape[0] + 1, shape[1])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    untouched = np.setdiff1d(np.arange(shape[0] + 1), inv)
    assert not got.numpy()[untouched].any()


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
