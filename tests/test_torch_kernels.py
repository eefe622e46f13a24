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
    assert ops.launches == {"embedding_bag": 0, "embedding_bag_ref": 1}
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


def _sum_in_csr_order(working, inv, w, order, offsets):
    """The kernel's arithmetic, one bag at a time: float32 adds in the CSR
    order, each term rounded after its multiply (no fused multiply-add)."""
    out = np.zeros((len(offsets) - 1, working.shape[1]), np.float32)
    for b in range(len(offsets) - 1):
        acc = np.zeros(working.shape[1], np.float32)
        for j in order[offsets[b]:offsets[b + 1]]:
            x = working[inv[j]]
            if w is not None:
                x = (x * w[j]).astype(np.float32)
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
    got = _sum_in_csr_order(working, inv, w, order, offsets)
    want = tref.embedding_bag_ref(_t(working), _t(inv), _t(seg), _t(w),
                                  num_bags).numpy()
    np.testing.assert_array_equal(got, want)


def test_autograd_backward_is_the_plain_vjp(monkeypatch):
    """The autograd.Function's backward, with the plain version standing in
    for the CUDA launch (which exists only on the card)."""
    working, inv, seg, w = _case(7, *SHAPES[2])
    num_bags = SHAPES[2][3]
    monkeypatch.setattr(ops, "embedding_bag_cuda", tref.embedding_bag_ref)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (num_bags, working.shape[1])).astype(np.float32))

    def grads(fn):
        wk = _t(working).clone().requires_grad_(True)
        ww = _t(w).clone().requires_grad_(True)
        (fn(wk, ww) * g).sum().backward()
        return wk.grad, ww.grad

    got = grads(lambda wk, ww: ops._Bag.apply(wk, _t(inv), _t(seg), ww,
                                              num_bags))
    want = grads(lambda wk, ww: tref.embedding_bag_ref(wk, _t(inv), _t(seg),
                                                       ww, num_bags))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
