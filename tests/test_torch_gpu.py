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
