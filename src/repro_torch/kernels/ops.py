"""Dispatch between the hand-written kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``.  What decides is where the tensor
lies: a CUDA tensor goes to the kernel, a CPU tensor to the plain version.
Nothing falls back: a CUDA tensor the kernel does not take raises.

``launches`` counts, per path, the calls that ran each function: the CUDA
kernels under their names (``embedding_bag``, ``embedding_bag_backward``,
``sparse_adagrad_apply``), the plain versions under the same name with
``_ref``.  A run resets it with ``reset_launches()`` and reads it afterwards
to show which path it took.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.embedding_bag import (
    embedding_bag_backward_cuda,
    embedding_bag_cuda,
)
from repro_torch.kernels.sparse_adagrad import (
    adagrad_row_updates,
    sparse_adagrad_apply_cuda,
)

_COMBINERS = ("sum", "mean", "sqrtn")

launches = {
    "embedding_bag": 0, "embedding_bag_ref": 0,
    "embedding_bag_backward": 0, "embedding_bag_backward_ref": 0,
    "sparse_adagrad_apply": 0, "sparse_adagrad_apply_ref": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def kernel_mode(t: torch.Tensor) -> str:
    """How a kernel op runs on ``t``: "cuda" (the kernel) or "ref"."""
    return "cuda" if t.is_cuda else "ref"


def resolve_fused(flag, device) -> bool:
    """Map ``TrainerConfig.fused_kernels`` to a bool for ``device``.

    ``None`` (auto) is on for CUDA and off for the CPU.  On the CPU both
    values run the plain versions.  CUDA has no unfused path: the plain
    versions run there only to check the kernels, so False raises.
    """
    on_cuda = torch.device(device).type == "cuda"
    if flag is None:
        return on_cuda
    if on_cuda and not flag:
        raise ValueError(
            "fused_kernels=False on CUDA: the embedding bag and the push run "
            "on the card only as their CUDA kernels; leave fused_kernels at "
            "None or True")
    return bool(flag)


class _Bag(torch.autograd.Function):
    """Forward and backward: the CUDA kernels.  The backward's working-row
    gradient is bit-equal to the plain vjp on the CPU (the reference's
    custom_vjp, ``repro/kernels/ops.py``, defines it as that vjp)."""

    @staticmethod
    def forward(ctx, working, inv, seg, weights, num_bags):
        ctx.save_for_backward(working, inv, seg, weights)
        out = embedding_bag_cuda(working, inv, seg, weights, num_bags)
        launches["embedding_bag"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        working, inv, seg, weights = ctx.saved_tensors
        need_wk, _, _, need_w, _ = ctx.needs_input_grad
        need_w = need_w and weights is not None
        if not (need_wk or need_w):
            return None, None, None, None, None
        g_wk, g_w = embedding_bag_backward_cuda(
            g.contiguous(), working, inv, seg, weights, need_wk, need_w)
        launches["embedding_bag_backward"] += 1
        return g_wk, None, None, g_w, None


class _BagRef(torch.autograd.Function):
    """The plain version and its vjp, counted (CPU tensors)."""

    @staticmethod
    def forward(ctx, working, inv, seg, weights, num_bags):
        ctx.save_for_backward(working, inv, seg, weights)
        launches["embedding_bag_ref"] += 1
        return ref.embedding_bag_ref(working, inv, seg, weights, num_bags)

    @staticmethod
    def backward(ctx, g):
        working, inv, seg, weights = ctx.saved_tensors
        need_wk, _, _, need_w, _ = ctx.needs_input_grad
        if not (need_wk or need_w):
            return None, None, None, None, None
        g_wk, g_w = ref.embedding_bag_backward_ref(
            g, working, inv, seg, weights, need_wk, need_w)
        launches["embedding_bag_backward_ref"] += 1
        return g_wk, None, None, g_w, None


def embedding_bag_working(working, inv, seg, weights, num_bags,
                          combiner="sum", fused=True):
    """Differentiable gather+bag over the pulled working set.

    CUDA: one kernel launch for the sum forward and one (two when the
    weights need a gradient) for its backward; the mean/sqrtn division stays
    outside, as the same expression the plain path uses, and autograd
    differentiates it.  CPU: the plain version.  ``fused=False`` is accepted
    only for CPU tensors.
    """
    if combiner not in _COMBINERS:
        raise ValueError(f"unknown combiner: {combiner!r}")
    num_bags = int(num_bags)
    if kernel_mode(working) == "ref":
        out = _BagRef.apply(working, inv, seg, weights, num_bags)
    elif not fused:
        raise ValueError("fused=False on CUDA tensors: the bag runs on the "
                         "card only as its CUDA kernel")
    else:
        out = _Bag.apply(working, inv, seg, weights, num_bags)
    if combiner != "sum":
        denom = ref.bag_combiner_denom_ref(seg, num_bags, combiner,
                                           working.dtype)
        out = out / denom[:, None]
    return out


def sparse_adagrad_apply(table, accum, uids, grads, *, lr, eps):
    """The push: AdaGrad row updates applied straight into the table and
    the accumulator, in place; returns the same ``(table, accum)``.

    The row math runs once, outside, via ``adagrad_row_updates`` (the same
    helper the unfused ``SparseAdagrad.apply_rows`` uses), so the CUDA
    kernel and the plain ``index_add_`` receive identical ``(delta, g2)``
    bits and give identical tables.
    """
    delta, g2 = adagrad_row_updates(accum.index_select(0, uids.long()), grads,
                                    table.dtype, lr=lr, eps=eps)
    if kernel_mode(table) == "ref":
        launches["sparse_adagrad_apply_ref"] += 1
        return ref.sparse_adagrad_apply_ref(table, accum, uids, delta, g2)
    out = sparse_adagrad_apply_cuda(table, accum, uids, delta, g2)
    launches["sparse_adagrad_apply"] += 1
    return out
