"""Dispatch between the hand-written kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``.  What decides is where the tensor
lies: a CUDA tensor goes to the kernel, a CPU tensor to the plain version.
Nothing falls back: a CUDA tensor the kernel does not take raises.

``launches`` counts, per path, the calls that ran each function: the CUDA
kernels under their names (``embedding_bag``, ``embedding_bag_backward``,
``sparse_adagrad_apply``, the cache tier's ``hash_lookup``,
``gather_rows_cached``, ``sparse_adagrad_cached_apply``, the SSD tier's
staged push ``sparse_adagrad``, the k-step local Adam step ``fused_adam``,
DLRM's ``dot_interaction`` and its backward ``dot_interaction_backward``,
and the LM's ``flash_attention`` (``flash_attention_window`` with a
sliding window, ``flash_attention_chunk`` with a chunk alone: one count a
launch) and its backward ``flash_attention_backward`` (likewise
``flash_attention_backward_window`` and ``flash_attention_backward_chunk``)),
the plain versions under the same name with ``_ref``.  A run resets it with
``reset_launches()`` and reads it afterwards to show which path it took.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dot_interaction import (
    dot_interaction_backward_cuda,
    dot_interaction_cuda,
)
from repro_torch.kernels.embedding_bag import (
    embedding_bag_backward_cuda,
    embedding_bag_cuda,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_backward_cuda,
    flash_attention_cuda,
    local_terms,
)
from repro_torch.kernels.fused_adam import fused_adam_cuda
from repro_torch.kernels.hash_map import hash_lookup_cuda
from repro_torch.kernels.sparse_adagrad import (
    adagrad_row_updates,
    gather_rows_cached_cuda,
    sparse_adagrad_apply_cuda,
    sparse_adagrad_cached_apply_cuda,
    sparse_adagrad_staged_cuda,
)

_COMBINERS = ("sum", "mean", "sqrtn")

launches = {
    "embedding_bag": 0, "embedding_bag_ref": 0,
    "embedding_bag_backward": 0, "embedding_bag_backward_ref": 0,
    "sparse_adagrad_apply": 0, "sparse_adagrad_apply_ref": 0,
    "hash_lookup": 0, "hash_lookup_ref": 0,
    "gather_rows_cached": 0, "gather_rows_cached_ref": 0,
    "sparse_adagrad_cached_apply": 0, "sparse_adagrad_cached_apply_ref": 0,
    "sparse_adagrad": 0, "sparse_adagrad_ref": 0,
    "fused_adam": 0, "fused_adam_ref": 0,
    "dot_interaction": 0, "dot_interaction_ref": 0,
    "dot_interaction_backward": 0, "dot_interaction_backward_ref": 0,
    "flash_attention": 0, "flash_attention_ref": 0,
    "flash_attention_window": 0, "flash_attention_chunk": 0,
    "flash_attention_backward": 0, "flash_attention_backward_ref": 0,
    "flash_attention_backward_window": 0,
    "flash_attention_backward_chunk": 0,
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

    CUDA: one extension call, the kernel doing the row math itself.  CPU:
    ``adagrad_row_updates`` on the gathered accumulator rows (the same
    helper the unfused ``SparseAdagrad.apply_rows`` uses), then the plain
    ``index_add_``; the two give the same bits.
    """
    if kernel_mode(table) == "ref":
        delta, g2 = adagrad_row_updates(accum.index_select(0, uids.long()),
                                        grads, table.dtype, lr=lr, eps=eps)
        launches["sparse_adagrad_apply_ref"] += 1
        return ref.sparse_adagrad_apply_ref(table, accum, uids, delta, g2)
    out = sparse_adagrad_apply_cuda(table, accum, uids, grads, lr=lr, eps=eps)
    launches["sparse_adagrad_apply"] += 1
    return out


def hash_lookup(key_tab, slot_tab, slot_uid, uids):
    """The cache tier's id -> slot probe: ``slots[i]`` = the live cache slot
    of ``uids[i]``, or -1.  An integer result: the kernel and the plain
    version walk the same chains and agree bit for bit."""
    if kernel_mode(key_tab) == "ref":
        launches["hash_lookup_ref"] += 1
        return ref.hash_lookup_ref(key_tab, slot_tab, slot_uid, uids)
    out = hash_lookup_cuda(key_tab, slot_tab, slot_uid, uids)
    launches["hash_lookup"] += 1
    return out


def gather_rows_cached(cache_rows, slots, drop_row=False):
    """The cached pull's gather: ``out[i] = cache_rows[slots[i]]``, with the
    probe's output as the index stream (``0 <= slots < C``); with
    ``drop_row`` one more row, zero (the working set's drop row), written
    by the same launch on CUDA."""
    if kernel_mode(cache_rows) == "ref":
        launches["gather_rows_cached_ref"] += 1
        return ref.gather_rows_cached_ref(cache_rows, slots, drop_row)
    out = gather_rows_cached_cuda(cache_rows, slots, drop_row=drop_row)
    launches["gather_rows_cached"] += 1
    return out


def sparse_adagrad_cached_apply(cache_rows, cache_accum, slots, grads, *,
                                lr, eps, uids=None):
    """The cached push: AdaGrad row updates applied into the device cache
    by slot, in place; returns the same ``(cache_rows, cache_accum)``.

    CUDA: one extension call, the kernel reading the accumulator rows and
    doing the row math itself; it finds the pads by the working set's
    ``uids`` (a slot order is not ascending), so there ``uids`` is
    required.  CPU: as the reference, the accumulator rows through
    ``gather_rows_cached``, the row math through ``adagrad_row_updates``,
    then the plain ``index_add_``; the two give the same bits.
    """
    if kernel_mode(cache_rows) == "cuda":
        if uids is None:
            raise ValueError("sparse_adagrad_cached_apply on CUDA tensors "
                             "needs the working set's uids (the kernel "
                             "skips the pads by them)")
        out = sparse_adagrad_cached_apply_cuda(cache_rows, cache_accum, slots,
                                               uids, grads, lr=lr, eps=eps)
        launches["sparse_adagrad_cached_apply"] += 1
        return out
    accum_rows = gather_rows_cached(cache_accum, slots)
    delta, g2 = adagrad_row_updates(accum_rows, grads, cache_rows.dtype,
                                    lr=lr, eps=eps)
    launches["sparse_adagrad_cached_apply_ref"] += 1
    return ref.sparse_adagrad_apply_ref(cache_rows, cache_accum, slots, delta,
                                        g2)


def sparse_adagrad(rows, accum, grads, *, lr, eps):
    """The SSD tier's staged push: dense-block AdaGrad over the pulled
    ``(C, D)`` working-set rows, in place; returns the same
    ``(rows, accum)``.  Row i ends bit-equal to row ``uids[i]`` after the
    host push (the same ``adagrad_row_updates`` bits)."""
    if kernel_mode(rows) == "ref":
        launches["sparse_adagrad_ref"] += 1
        return ref.sparse_adagrad_ref(rows, accum, grads, lr, eps)
    out = sparse_adagrad_staged_cuda(rows, accum, grads, lr=lr, eps=eps)
    launches["sparse_adagrad"] += 1
    return out


def fused_adam(params, grads, m, v_local, v_hat, *, t, lr, b1, b2, k,
               local_v_warmup, mhat_s=None, vhat_s=None, weight_decay=0.0,
               table=None):
    """The k-step local Adam step over lists of leaves, in place (see
    ``ref.fused_adam_ref``); returns ``(params, m, v_local)``.  On CUDA
    leaves one kernel launch over every leaf; ``table`` is the caller's
    ``AdamTable`` (its leaves' pointers, kept across steps)."""
    kw = dict(t=t, lr=lr, b1=b1, b2=b2, k=k, local_v_warmup=local_v_warmup,
              mhat_s=mhat_s, vhat_s=vhat_s, weight_decay=weight_decay)
    if kernel_mode(params[0]) == "ref":
        launches["fused_adam_ref"] += 1
        return ref.fused_adam_ref(params, grads, m, v_local, v_hat, **kw)
    out = fused_adam_cuda(params, grads, m, v_local, v_hat, table=table, **kw)
    launches["fused_adam"] += 1
    return out


class _DotInteraction(torch.autograd.Function):
    """Forward and backward: the CUDA kernels (8 and 8b)."""

    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        out = dot_interaction_cuda(feats)
        if out.numel():
            launches["dot_interaction"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        (feats,) = ctx.saved_tensors
        # the gradient of a column slice of the top MLP's input
        # (``torch.cat([x, inter])``) arrives as a strided view
        out = dot_interaction_backward_cuda(g.contiguous(), feats)
        if out.numel():
            launches["dot_interaction_backward"] += 1
        return out


class _DotInteractionRef(torch.autograd.Function):
    """The plain version and its vjp (PyTorch's autograd through
    ``ref.dot_interaction_ref``), counted (CPU tensors)."""

    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        launches["dot_interaction_ref"] += 1
        return ref.dot_interaction_ref(feats)

    @staticmethod
    def backward(ctx, g):
        (feats,) = ctx.saved_tensors
        with torch.enable_grad():
            f = feats.detach().requires_grad_(True)
            (out,) = torch.autograd.grad(ref.dot_interaction_ref(f), f, g)
        launches["dot_interaction_backward_ref"] += 1
        return out


def dot_interaction(feats):
    """DLRM's interaction ``(B, F, D) -> (B, F (F - 1) / 2)``, in the input
    dtype (see ``ref.dot_interaction_ref``), differentiable.  CUDA: the
    kernel, and kernel 8b for its backward; CPU: the plain version, its
    backward autograd's vjp of it."""
    if kernel_mode(feats) == "ref":
        return _DotInteractionRef.apply(feats)
    return _DotInteraction.apply(feats)


def _counter(base, window, chunk):
    """The launch counter of a flash kernel call: ``base`` with
    ``_window`` (a sliding window), ``_chunk`` (a chunk alone) or
    neither."""
    return (f"{base}_window" if window is not None else
            f"{base}_chunk" if chunk is not None else base)


class _FlashAttention(torch.autograd.Function):
    """Forward and backward: the CUDA kernels (9 and 9b), the backward
    under the forward's window and chunk.  Under autograd the forward also
    writes the rows' log-sum-exp, which the backward takes with q, k, v
    and the output; outside it (prefill) it writes the output alone, the
    same bits."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        if any(ctx.needs_input_grad[:3]):
            out, lse = flash_attention_cuda(q, k, v, causal, return_lse=True,
                                            window=window, chunk=chunk)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = flash_attention_cuda(q, k, v, causal, window=window,
                                       chunk=chunk)
        ctx.terms = (causal, window, chunk)
        if out.numel():
            launches[_counter("flash_attention", window, chunk)] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_backward_cuda(q, k, v, out, lse, g,
                                              *ctx.terms)
        if q.numel():
            launches[_counter("flash_attention_backward",
                              *ctx.terms[1:])] += 1
        return (*grads, None, None, None)


class _FlashAttentionRef(torch.autograd.Function):
    """The plain version and its vjp (``ref.flash_attention_backward_ref``,
    autograd's vjp of it), counted (CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.terms = (causal, window, chunk)
        launches["flash_attention_ref"] += 1
        return ref.flash_attention_ref(q, k, v, causal, window, chunk)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        grads = ref.flash_attention_backward_ref(q, k, v, g, *ctx.terms)
        launches["flash_attention_backward_ref"] += 1
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal=True, window=None, chunk=None):
    """Softmax attention in the model's layout, q (B, S, H, hd) over k and v
    (B, S, Kv, hd), in q's dtype, under ``ref.attention_mask(S, causal,
    window, chunk)`` (see ``ref.flash_attention_ref``), differentiable.
    CUDA: the kernel, and kernel 9b for its backward, with the same
    terms; CPU: the plain version, its backward autograd's vjp of it."""
    if kernel_mode(q) == "ref":
        # raises on bad terms (flash_attention_cuda checks its own)
        local_terms(causal, window, chunk)
        return _FlashAttentionRef.apply(q, k, v, causal, window, chunk)
    return _FlashAttention.apply(q, k, v, causal, window, chunk)
