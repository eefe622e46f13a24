"""Embedding bag over the pulled working set: the hand-written CUDA kernels.

Forward: ``out[b] = sum_{j: seg[j]==b} w[j] * working[inv[j]]``, with
``seg`` in any order.  Counterpart of
``repro/kernels/embedding_bag.py::embedding_bag_pallas``.

Backward: ``g_work[r] = sum_{j: inv[j]==r} w[j] * g[seg[j]]`` (every working
row written, untouched rows as zeros) and, when the weights need it,
``g_w[j] = <g[seg[j]], working[inv[j]]>``.  The reference's backward is the
XLA vjp of its plain version; the port's is a kernel because the plain vjp's
scatter adds with float atomics on the card, so its bits would change from
run to run.

The kernels are ``csrc/embedding_bag.cu`` (its header says how they are laid
out and what bounds them), bound by ``csrc/bindings.cpp`` and built by
``kernels.build``.  The wrappers prepare the index streams with PyTorch ops:
a stable sort gives each output row's entries in ascending original
position (``order``) and the CSR ``offsets`` — by ``seg`` for the forward,
by ``inv`` for the backward, whose ``seg`` and weight streams are also
gathered into that order, so its kernel reads them contiguously.  Entries
whose ``seg`` lies outside
[0, num_bags) fall in no bag: the forward drops them and their gradients
are zero, as in the reference's segment sum.  ``inv`` must index rows of
``working``; on the working-set path it does by construction (the drop row
is the last row).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import extension


def _check_inputs(working, inv, seg, weights, num_bags):
    """Raise on anything the bag does not take (either path)."""
    if working.dim() != 2 or working.dtype != torch.float32:
        raise ValueError(
            f"working must be 2-D float32, got {tuple(working.shape)} "
            f"{working.dtype}")
    for name, t in (("inv", inv), ("seg", seg)):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"{name} must be 1-D int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if seg.shape != inv.shape:
        raise ValueError(f"seg {tuple(seg.shape)} and inv {tuple(inv.shape)} "
                         "differ in length")
    if weights is not None and (weights.shape != inv.shape
                                or weights.dtype != torch.float32):
        raise ValueError(f"weights must be float32 of shape {tuple(inv.shape)},"
                         f" got {tuple(weights.shape)} {weights.dtype}")
    tensors = [working, inv, seg] + ([weights] if weights is not None else [])
    if any(t.device != working.device for t in tensors):
        raise ValueError("working, inv, seg and weights must share a device")
    if int(num_bags) < 1:
        raise ValueError(f"num_bags must be positive, got {num_bags}")


def _check_cuda(tensors, what):
    if not tensors[0].is_cuda:
        raise ValueError(f"{what} takes CUDA tensors, got {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors if t is not None):
        raise ValueError(f"{what} takes contiguous tensors")


def csr_from_segments(seg, num_bags):
    """(order, offsets): entries of bag b are ``order[offsets[b]:offsets[b+1]]``
    in ascending original position."""
    sorted_seg, order = torch.sort(seg, stable=True)
    bounds = torch.arange(num_bags + 1, dtype=seg.dtype, device=seg.device)
    return order, torch.searchsorted(sorted_seg, bounds)


def sorted_streams(keys, num_rows, index, weights):
    """``(index_sorted, weights_sorted, offsets)``: the entries grouped by
    ``keys`` in ascending original position (``csr_from_segments``), with
    the index and weight streams gathered into that order."""
    order, offsets = csr_from_segments(keys, num_rows)
    w = None if weights is None else weights.index_select(0, order)
    return index.index_select(0, order), w, offsets


def launch(working, inv, weights, order, offsets, num_bags):
    """One launch of the forward kernel on prepared CSR indices."""
    out = torch.empty((num_bags, working.shape[1]), dtype=working.dtype,
                      device=working.device)
    extension().embedding_bag_forward(working, inv, weights, order, offsets,
                                      out)
    return out


def embedding_bag_cuda(working, inv, seg, weights, num_bags):
    """The bag on CUDA tensors: index preparation, then one kernel launch.
    Raises for tensors that are not on a CUDA device, or not contiguous."""
    _check_inputs(working, inv, seg, weights, num_bags)
    _check_cuda([working, inv, seg, weights], "embedding_bag_cuda")
    order, offsets = csr_from_segments(seg, int(num_bags))
    return launch(working, inv, weights, order, offsets, int(num_bags))


def launch_backward(g, seg_sorted, w_sorted, offsets, working_rows):
    """One launch of the working-row gradient kernel on streams sorted by
    working row."""
    g_work = torch.empty((working_rows, g.shape[1]), dtype=g.dtype,
                         device=g.device)
    extension().embedding_bag_backward(g, seg_sorted, w_sorted, offsets,
                                       g_work)
    return g_work


def launch_weight_grad(g, seg, working, inv):
    """One launch of the weight-gradient kernel."""
    g_w = torch.empty(seg.shape, dtype=g.dtype, device=g.device)
    extension().embedding_bag_weight_grad(g, seg, working, inv, g_w)
    return g_w


def embedding_bag_backward_cuda(g, working, inv, seg, weights,
                                need_working=True, need_weights=False):
    """Gradients of the bag's sum on CUDA tensors: ``(g_work, g_w)``, each
    None where it is not needed.  ``g`` is the cotangent of the forward's
    (num_bags, dim) output."""
    num_bags = g.shape[0]
    _check_inputs(working, inv, seg, weights, num_bags)
    if g.dim() != 2 or g.dtype != torch.float32 or g.shape[1] != \
            working.shape[1]:
        raise ValueError(f"g must be float32 (num_bags, {working.shape[1]}), "
                         f"got {tuple(g.shape)} {g.dtype}")
    _check_cuda([g, working, inv, seg, weights],
                "embedding_bag_backward_cuda")
    g_work = g_w = None
    if need_working:
        g_work = launch_backward(
            g, *sorted_streams(inv, working.shape[0], seg, weights),
            working.shape[0])
    if need_weights:
        g_w = launch_weight_grad(g, seg, working, inv)
    return g_work, g_w
