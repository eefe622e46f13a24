"""Plain PyTorch versions of the kernels (the correctness contracts).

Counterpart of ``repro/kernels/ref.py``.  The CPU path runs these, and the
card checks each hand-written kernel against them.
"""

from __future__ import annotations

import torch


def embedding_bag_ref(working, inv, seg, weights, num_bags):
    """out[b] = sum_{j: seg[j]==b} w[j] * working[inv[j]] (seg in any order).

    On the CPU the scatter adds in ascending j, the order of the reference's
    ``jax.ops.segment_sum``; segments outside [0, num_bags) are dropped, as
    there.
    """
    emb = working.index_select(0, inv.long())
    if weights is not None:
        emb = emb * weights[:, None].to(working.dtype)
    return _segment_sum(emb, seg, num_bags)


def embedding_bag_backward_ref(g, working, inv, seg, weights,
                               need_working=True, need_weights=False):
    """The vjp of ``embedding_bag_ref`` (PyTorch's autograd through its index
    ops): ``(g_work, g_w)``, each None where it is not needed.  On the CPU
    the working-row scatter (``index_add_``) adds in ascending entry order;
    on the card it adds with float atomics, in no fixed order."""
    g_work = g_w = None
    need_weights = need_weights and weights is not None
    with torch.enable_grad():
        wk = working.detach().requires_grad_(need_working)
        w = weights
        if need_weights:
            w = weights.detach().requires_grad_(True)
        out = embedding_bag_ref(wk, inv, seg, w, g.shape[0])
        wrt = [t for t, need in ((wk, need_working), (w, need_weights))
               if need]
        if wrt:
            grads = torch.autograd.grad(out, wrt, g)
            g_work = grads[0] if need_working else None
            g_w = grads[-1] if need_weights else None
    return g_work, g_w


def _segment_sum(x, seg, num_bags):
    """Row j of ``x`` added into row seg[j]; out-of-range segments land in a
    spare row that is cut off."""
    seg = seg.long()
    idx = torch.where((seg >= 0) & (seg < num_bags), seg, num_bags)
    out = torch.zeros((num_bags + 1,) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    if x.dim() == 2:
        idx = idx[:, None].expand(-1, x.shape[1])
    return out.scatter_add_(0, idx, x)[:num_bags]


def bag_combiner_denom_ref(seg, num_bags, combiner, dtype):
    """Per-bag divisor for mean/sqrtn: the same expression on the kernel and
    the plain path (the division stays outside the kernel either way)."""
    cnt = _segment_sum(torch.ones(seg.shape, dtype=dtype, device=seg.device),
                       seg, num_bags)
    denom = torch.clamp_min(cnt, 1.0)
    if combiner == "sqrtn":
        denom = torch.sqrt(denom)
    return denom


def embedding_bag_combiner_ref(working, inv, seg, weights, num_bags, combiner):
    out = embedding_bag_ref(working, inv, seg, weights, num_bags)
    if combiner == "sum":
        return out
    if combiner not in ("mean", "sqrtn"):
        raise ValueError(f"unknown combiner: {combiner!r}")
    denom = bag_combiner_denom_ref(seg, num_bags, combiner, working.dtype)
    return out / denom[:, None]


def sparse_adagrad_apply_ref(table, accum, uids, delta, g2):
    """The push of precomputed ``(delta, g2)`` rows, in place:
    ``table[uids] += delta; accum[uids] += g2`` by ``index_add_``, returning
    the same two tensors.  The pads of ``pull_working_set``'s layout repeat
    ``uids[0]`` with ``delta = -0.0`` and ``g2 = +0.0``, which leave the row's
    bits unchanged in any order of the adds."""
    idx = uids.long()
    table.index_add_(0, idx, delta.to(table.dtype))
    accum.index_add_(0, idx, g2)
    return table, accum
