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

# (capacity, dim, nnz, num_bags): every dim class of the kernel, empty bags
SHAPES = [(37, 16, 101, 19), (64, 24, 40, 53), (200, 64, 300, 120),
          (90, 100, 257, 40), (64, 200, 150, 31)]


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_bag_backward_matches_plain_vjp(shape):
    """Working-row grads bit-equal to the CPU plain vjp (the kernel adds in
    its order without fused multiply-adds); weight grads within
    rtol = atol = 1e-5 (the plain version sums each dot product in another
    order); two runs bit-equal."""
    _cuda_or_skip()
    cpu = _grad_case(12, *shape)
    dev = [x.cuda() for x in cpu]
    got = tbag.embedding_bag_backward_cuda(*dev, need_working=True,
                                           need_weights=True)
    again = tbag.embedding_bag_backward_cuda(*dev, need_working=True,
                                             need_weights=True)
    torch.cuda.synchronize()
    want = tref.embedding_bag_backward_ref(*cpu, need_working=True,
                                           need_weights=True)
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


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
])
def test_cuda_push_matches_plain_version(rows, D, n_ids, capacity):
    """The push kernel and the plain index_add_ receive the same
    (delta, g2) and must give the same bits, with untouched rows unchanged
    and two runs equal."""
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
        got = sparse_adagrad_apply_cuda(t, a, uids.cuda(), delta.cuda(),
                                        g2.cuda())
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
    """uid * dim above 2^31: the kernel's table offsets are 64-bit."""
    _cuda_or_skip()
    from repro_torch.kernels.sparse_adagrad import sparse_adagrad_apply_cuda

    D = 64
    rows = (1 << 31) // D + 4096                 # 8.6 GB per tensor
    table = torch.zeros((rows, D), device="cuda")
    accum = torch.ones((rows, D), device="cuda")
    uids = torch.tensor([7, (1 << 31) // D + 3, rows - 1], dtype=torch.int32,
                        device="cuda")
    delta = torch.arange(3 * D, dtype=torch.float32,
                         device="cuda").reshape(3, D)
    sparse_adagrad_apply_cuda(table, accum, uids, delta, delta * 2)
    torch.cuda.synchronize()
    for i, u in enumerate(uids.tolist()):
        assert torch.equal(table[u], delta[i])
        assert torch.equal(accum[u], 1 + delta[i] * 2)
    assert int(torch.count_nonzero(table)) == int(
        torch.count_nonzero(delta))
