"""The working-set AdaGrad pushes, their row arithmetic, and the cached
row gather: the CUDA kernels' wrappers.

Counterpart of ``repro/kernels/sparse_adagrad.py``.  ``adagrad_row_updates``
is the AdaGrad row math, computed once with PyTorch ops and shared by the
kernels and the plain versions, so both receive the same ``(delta, g2)``
bits.  The kernels are in ``csrc/sparse_adagrad.cu`` (its header states the
``uids`` layout the pushes rely on and how they treat the pads):

  - ``sparse_adagrad_apply_cuda``: the push into the table, by ``uids``;
  - ``sparse_adagrad_cached_apply_cuda``: the push into the device cache,
    by ``slots`` (the hash probe's output), the pads found by ``uids``;
  - ``gather_rows_cached_cuda``: ``out[i] = cache_rows[slots[i]]``;
  - ``sparse_adagrad_staged_cuda``: the SSD tier's staged push, dense-block
    AdaGrad over the pulled ``(C, D)`` rows, which computes the row math of
    ``adagrad_row_updates`` itself, with the same roundings.

The pushes update their two tensors in place, the port's counterpart of the
reference's buffer donation (``input_output_aliases``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import extension


def adagrad_row_updates(accum_rows, grads, table_dtype, *, lr, eps):
    """``(delta, g2)`` with ``g2 = g^2`` and
    ``delta = -lr * g / (sqrt(accum_rows + g^2) + eps)`` cast to the table
    dtype, in the reference's order and with the reference's roundings.

    - XLA fuses the reference's ``a + g*g`` into one single-rounded
      multiply-add, so ``a + g^2`` is taken here in float64 (where ``g^2`` is
      exact) and rounded once to float32.
    - The square root is taken in float64 and rounded to float32: that is
      the correctly rounded float32 root on the CPU and on the card alike
      (PyTorch's CPU float32 ``sqrt`` is not correctly rounded).
    - ``g2``, the ``+ eps`` and the division are plain float32 ops, bit-equal
      to the reference's.

    The result is computed once and feeds both the kernel and the plain
    version, so the two get the same bits.
    """
    g = grads.to(torch.float32)
    g2 = torch.square(g)
    g64 = g.double()
    a_new = (accum_rows.double() + g64 * g64).float()
    root = torch.sqrt(a_new.double()).float()
    delta = -lr * g / (root + eps)
    return delta.to(table_dtype), g2


def _check_push(table, accum, uids, delta, g2, what="sparse_adagrad_apply"):
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"table must be 2-D float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if accum.shape != table.shape or accum.dtype != torch.float32:
        raise ValueError(f"accum must be float32 {tuple(table.shape)}, got "
                         f"{tuple(accum.shape)} {accum.dtype}")
    if uids.dim() != 1 or uids.dtype != torch.int32:
        raise ValueError(f"uids must be 1-D int32, got {tuple(uids.shape)} "
                         f"{uids.dtype}")
    rows = (uids.shape[0], table.shape[1])
    for name, t in (("delta", delta), ("g2", g2)):
        if tuple(t.shape) != rows or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {rows}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors = (table, accum, uids, delta, g2)
    if any(t.device != table.device for t in tensors):
        raise ValueError("table, accum, uids, delta and g2 must share a "
                         "device")
    if not table.is_cuda:
        raise ValueError(f"{what}_cuda takes CUDA tensors, got {table.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}_cuda takes contiguous tensors")


def sparse_adagrad_apply_cuda(table, accum, uids, delta, g2):
    """``table[uids] += delta; accum[uids] += g2`` in place by one kernel
    launch on the current stream; returns the same ``(table, accum)``
    tensors.  ``uids`` as ``pull_working_set`` lays them out."""
    _check_push(table, accum, uids, delta, g2)
    extension().sparse_adagrad_apply(table, accum, uids, delta, g2)
    return table, accum


def sparse_adagrad_cached_apply_cuda(cache_rows, cache_accum, slots, uids,
                                     delta, g2):
    """``cache_rows[slots] += delta; cache_accum[slots] += g2`` in place by
    one kernel launch on the current stream; returns the same two tensors.
    ``uids`` are the working set's ids as ``pull_working_set`` lays them out
    and ``slots`` their cache slots: a position whose uid repeats the one
    before it (a pad) is skipped."""
    what = "sparse_adagrad_cached_apply"
    _check_push(cache_rows, cache_accum, uids, delta, g2, what)
    if (slots.shape != uids.shape or slots.dtype != torch.int32
            or slots.device != uids.device or not slots.is_contiguous()):
        raise ValueError(f"slots must be contiguous int32 "
                         f"{tuple(uids.shape)} on {uids.device}, got "
                         f"{tuple(slots.shape)} {slots.dtype} {slots.device}")
    extension().sparse_adagrad_cached_apply(cache_rows, cache_accum, slots,
                                            uids, delta, g2)
    return cache_rows, cache_accum


def gather_rows_cached_cuda(cache_rows, slots):
    """``out[i] = cache_rows[slots[i]]`` by one kernel launch on the current
    stream.  The caller passes ``0 <= slots < C`` (the cache tier does: its
    pull's slots are all live, its lookup's misses read slot 0); the kernel
    writes a zero row for a slot outside that range."""
    if cache_rows.dim() != 2 or cache_rows.dtype != torch.float32:
        raise ValueError(f"cache_rows must be 2-D float32, got "
                         f"{tuple(cache_rows.shape)} {cache_rows.dtype}")
    if slots.dim() != 1 or slots.dtype != torch.int32:
        raise ValueError(f"slots must be 1-D int32, got {tuple(slots.shape)} "
                         f"{slots.dtype}")
    if slots.device != cache_rows.device:
        raise ValueError("cache_rows and slots must share a device")
    if not cache_rows.is_cuda:
        raise ValueError(f"gather_rows_cached_cuda takes CUDA tensors, got "
                         f"{cache_rows.device}")
    if not (cache_rows.is_contiguous() and slots.is_contiguous()):
        raise ValueError("gather_rows_cached_cuda takes contiguous tensors")
    out = torch.empty((slots.shape[0], cache_rows.shape[1]),
                      dtype=cache_rows.dtype, device=cache_rows.device)
    extension().gather_rows_cached(cache_rows, slots, out)
    return out


def sparse_adagrad_staged_cuda(rows, accum, grads, *, lr, eps):
    """``rows += delta; accum += g^2`` in place over staged ``(C, D)``
    working-set rows, with ``(delta, g^2)`` the bits of
    ``adagrad_row_updates(accum, grads)``, by one kernel launch on the
    current stream; returns the same ``(rows, accum)``."""
    for name, t in (("rows", rows), ("accum", accum), ("grads", grads)):
        if t.dim() != 2 or t.dtype != torch.float32:
            raise ValueError(f"{name} must be 2-D float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.shape != rows.shape or t.device != rows.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, "
                             f"rows {tuple(rows.shape)} on {rows.device}")
    if not rows.is_cuda:
        raise ValueError(f"sparse_adagrad_staged_cuda takes CUDA tensors, "
                         f"got {rows.device}")
    if not (rows.is_contiguous() and accum.is_contiguous()
            and grads.is_contiguous()):
        raise ValueError("sparse_adagrad_staged_cuda takes contiguous "
                         "tensors")
    extension().sparse_adagrad_staged(rows, accum, grads, float(lr),
                                      float(eps))
    return rows, accum
