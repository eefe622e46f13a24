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
out and what bounds them), bound by ``csrc/bind_embedding_bag.cpp`` and built by
``kernels.build``.  Both walks need each output row's entries in ascending
original position, and each direction makes one call of the extension,
which builds those index streams on the card without a sort (a stable
order by key, the offsets, the carried index and the weights gathered into
that order, so the kernels read them contiguously) and then runs its
kernels.  The forward keys the entries by ``seg`` and carries ``inv``
(``forward_streams`` returns those streams alone, and ``walk`` runs the walk
alone on given streams); the backward keys them by ``inv`` and carries
``seg``, and also lists the rows of more and of at most ``LONG_ROW``
entries (``backward_streams``).  ``csr_from_segments`` is the forward
streams' plain version, by a stable sort.  Entries whose ``seg`` lies
outside [0, num_bags) fall in no bag: the forward drops them and their
gradients are zero, as in the reference's segment sum.
``inv`` must index rows of ``working``; on the working-set path it does by
construction (the drop row is the last row).  Rows may be as wide as the
extension's ``max_bag_dim`` (its binding raises past it): past 256 the
kernels run once a column tile of at most 256 on the one set of index
streams, and every column keeps the bits of the entries' order.
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


# The backward kernel's thresholds (kLongRow and kVeryLong in
# csrc/embedding_bag.cu): rows of more entries than LONG_ROW take its
# long-row path, and those of more than VERY_LONG are handed out first.
LONG_ROW = 128
VERY_LONG = 1024


def csr_from_segments(seg, num_bags):
    """(order, offsets): entries of bag b are ``order[offsets[b]:offsets[b+1]]``
    in ascending original position.  The plain version of the forward's
    index streams (``forward_streams``), by a stable sort; entries whose
    ``seg`` lies below 0 sort before bag 0, those at ``num_bags`` or above
    after the last bag."""
    sorted_seg, order = torch.sort(seg, stable=True)
    bounds = torch.arange(num_bags + 1, dtype=seg.dtype, device=seg.device)
    return order, torch.searchsorted(sorted_seg, bounds)


def forward_streams(working, inv, seg, weights, num_bags):
    """The forward's index streams, as its call of the extension builds them
    on the card before the walk, without the walk: ``(inv_sorted, w_sorted,
    offsets, seg_sorted)``.  The entries are grouped by ``seg`` in ascending
    original position (a stable order); a ``seg`` outside [0, num_bags)
    reads ``num_bags`` and sorts last.  ``offsets`` (int64, num_bags + 1)
    bounds each bag's entries; ``w_sorted`` is None without weights.  CUDA
    tensors only."""
    _check_inputs(working, inv, seg, weights, num_bags)
    _check_cuda([working, inv, seg, weights], "forward_streams")
    return tuple(extension().embedding_bag_forward(
        working, inv, seg, weights, int(num_bags), True))


def walk(working, inv_sorted, w_sorted, offsets):
    """The forward's walk alone on given streams (``forward_streams``'s
    first three): ``out[b]`` sums bag b's entries in stream order.  CUDA
    tensors only."""
    _check_cuda([working, inv_sorted, w_sorted, offsets], "walk")
    out = torch.empty((offsets.numel() - 1, working.shape[1]),
                      dtype=working.dtype, device=working.device)
    extension().embedding_bag_walk(working, inv_sorted, w_sorted, offsets,
                                   out)
    return out


def backward_streams(g, inv, seg, weights, working_rows):
    """The working-row gradient's index streams, as the backward's call of
    the extension builds them on the card before its kernels run, without
    the kernels: ``(seg_sorted, w_sorted, offsets, keys_sorted, row_lists)``.
    The entries are grouped by ``inv`` in ascending original position (a
    stable order); an ``inv`` outside [0, working_rows) reads
    ``working_rows`` and sorts last.  ``offsets`` (int64) bounds each row's
    entries; ``row_lists`` (int32) is ``[n_very, n_long, LONG_ROW,
    n_short]``, then room for ``nnz // (LONG_ROW + 1)`` rows of more than
    ``LONG_ROW`` entries (the ``n_very`` of more than ``VERY_LONG`` from the
    front, the other ``n_long`` from the back), then room for ``nnz`` rows
    of 1 to ``LONG_ROW`` (the ``n_short`` from the front), each part in no
    fixed order.  CUDA tensors only."""
    _check_cuda([g, inv, seg, weights], "backward_streams")
    return tuple(extension().embedding_bag_backward(
        g, inv, seg, weights, int(working_rows), True))


def embedding_bag_cuda(working, inv, seg, weights, num_bags):
    """The bag on CUDA tensors: one call of the extension (the index streams,
    then the walk).  Raises for tensors that are not on a CUDA device, or
    not contiguous."""
    _check_inputs(working, inv, seg, weights, num_bags)
    _check_cuda([working, inv, seg, weights], "embedding_bag_cuda")
    out, = extension().embedding_bag_forward(working, inv, seg, weights,
                                             int(num_bags))
    return out


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
        # the index streams and the kernels in one call of the extension
        g_work, = extension().embedding_bag_backward(g, inv, seg, weights,
                                                     working.shape[0])
    if need_weights:
        g_w = launch_weight_grad(g, seg, working, inv)
    return g_work, g_w
