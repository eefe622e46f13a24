"""Dispatch between the hand-written kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``.  What decides is where the tensor
lies: a CUDA tensor goes to the kernel, a CPU tensor to the plain version.
Nothing falls back: a CUDA tensor the kernel does not take raises.

``launches`` counts, per path, the calls that ran the bag: ``"embedding_bag"``
for the CUDA kernel, ``"embedding_bag_ref"`` for the plain version.  A run
resets it with ``reset_launches()`` and reads it afterwards to show which
path it took.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.embedding_bag import embedding_bag_cuda

_COMBINERS = ("sum", "mean", "sqrtn")

launches = {"embedding_bag": 0, "embedding_bag_ref": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def kernel_mode(t: torch.Tensor) -> str:
    """How a kernel op runs on ``t``: "cuda" (the kernel) or "ref"."""
    return "cuda" if t.is_cuda else "ref"


def resolve_fused(flag, device) -> bool:
    """Map ``TrainerConfig.fused_kernels`` to a bool for ``device``.

    ``None`` (auto) is on for CUDA and off for the CPU.  On the CPU both
    values run the plain version.  CUDA has no unfused path: the plain
    version runs there only to check the kernel, so False raises.
    """
    on_cuda = torch.device(device).type == "cuda"
    if flag is None:
        return on_cuda
    if on_cuda and not flag:
        raise ValueError(
            "fused_kernels=False on CUDA: the embedding bag runs on the card "
            "only as its CUDA kernel; leave fused_kernels at None or True")
    return bool(flag)


class _Bag(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the vjp of the plain version, as
    the reference's custom_vjp (``repro/kernels/ops.py``) defines it."""

    @staticmethod
    def forward(ctx, working, inv, seg, weights, num_bags):
        ctx.num_bags = num_bags
        ctx.save_for_backward(working, inv, seg, weights)
        out = embedding_bag_cuda(working, inv, seg, weights, num_bags)
        launches["embedding_bag"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        working, inv, seg, weights = ctx.saved_tensors
        need_wk, _, _, need_w, _ = ctx.needs_input_grad
        need_w = need_w and weights is not None
        g_wk = g_w = None
        with torch.enable_grad():
            wk = working.detach().requires_grad_(need_wk)
            w = weights
            if need_w:
                w = weights.detach().requires_grad_(True)
            out = ref.embedding_bag_ref(wk, inv, seg, w, ctx.num_bags)
            wrt = [t for t, need in ((wk, need_wk), (w, need_w)) if need]
            if wrt:
                grads = torch.autograd.grad(out, wrt, g)
                g_wk = grads[0] if need_wk else None
                g_w = grads[-1] if need_w else None
        return g_wk, None, None, g_w, None


def embedding_bag_working(working, inv, seg, weights, num_bags,
                          combiner="sum", fused=True):
    """Differentiable gather+bag over the pulled working set.

    CUDA: one kernel launch for the sum; the mean/sqrtn division stays
    outside, as the same expression the plain path uses.  CPU: the plain
    version.  ``fused=False`` is accepted only for CPU tensors.
    """
    if combiner not in _COMBINERS:
        raise ValueError(f"unknown combiner: {combiner!r}")
    num_bags = int(num_bags)
    if kernel_mode(working) == "ref":
        launches["embedding_bag_ref"] += 1
        return ref.embedding_bag_combiner_ref(
            working, inv, seg, weights, num_bags, combiner)
    if not fused:
        raise ValueError("fused=False on CUDA tensors: the bag runs on the "
                         "card only as its CUDA kernel")
    out = _Bag.apply(working, inv, seg, weights, num_bags)
    if combiner != "sum":
        denom = ref.bag_combiner_denom_ref(seg, num_bags, combiner,
                                           working.dtype)
        out = out / denom[:, None]
    return out
