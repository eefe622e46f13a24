"""The working-set AdaGrad pushes, their row arithmetic, and the cached
row gather: the CUDA kernels' wrappers.

Counterpart of ``repro/kernels/sparse_adagrad.py``.  ``adagrad_row_updates``
is the AdaGrad row math in PyTorch ops, the plain versions' (and the
reference's, which computes it outside its Pallas pushes).  The kernels are
in ``csrc/sparse_adagrad.cu`` (its header states the ``uids`` layout the
pushes rely on and how they treat the pads), and each does the same row
math itself, with the same roundings:

  - ``sparse_adagrad_apply_cuda``: the push into the table, by ``uids``;
  - ``sparse_adagrad_cached_apply_cuda``: the push into the device cache,
    by ``slots`` (the hash probe's output), the pads found by ``uids``;
  - ``gather_rows_cached_cuda``: ``out[i] = cache_rows[slots[i]]``, with
    the working set's zero drop row after the rows if asked;
  - ``sparse_adagrad_staged_cuda``: the SSD tier's staged push, dense-block
    AdaGrad over the pulled ``(C, D)`` rows.

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

    The plain versions (the CPU path) run it; the CUDA kernels do the same
    operations an element (``adagrad_element`` in ``csrc/sparse_adagrad.cu``)
    with the same roundings, so the two give the same bits.
    """
    g = grads.to(torch.float32)
    g2 = torch.square(g)
    g64 = g.double()
    a_new = (accum_rows.double() + g64 * g64).float()
    root = torch.sqrt(a_new.double()).float()
    delta = -lr * g / (root + eps)
    return delta.to(table_dtype), g2


def _check_cuda(t, what):
    """Only the device is tested here, so that CPU tensors never reach the
    extension; the binding makes every other check, once, and raises
    ``ValueError``."""
    if not t.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors, got {t.device}")


def sparse_adagrad_apply_cuda(table, accum, uids, grads, *, lr, eps):
    """The push: ``table[uids]``, ``accum[uids]`` updated in place with the
    bits of ``adagrad_row_updates(accum[uids], grads)`` followed by
    ``index_add_``, by one kernel launch on the current stream (the row
    math in the kernel); returns the same ``(table, accum)``.  ``uids`` as
    ``pull_working_set`` lays them out; the pads' gradient rows are not
    read."""
    _check_cuda(table, "sparse_adagrad_apply_cuda")
    extension().sparse_adagrad_apply(table, accum, uids, grads, float(lr),
                                     float(eps))
    return table, accum


def sparse_adagrad_cached_apply_cuda(cache_rows, cache_accum, slots, uids,
                                     grads, *, lr, eps):
    """The cached push: ``cache_rows[slots]``, ``cache_accum[slots]``
    updated in place as ``sparse_adagrad_apply_cuda`` updates the table, by
    one kernel launch on the current stream; returns the same two tensors.
    ``uids`` are the working set's ids as ``pull_working_set`` lays them
    out and ``slots`` their cache slots: a position whose uid repeats the
    one before it (a pad) is skipped."""
    _check_cuda(cache_rows, "sparse_adagrad_cached_apply_cuda")
    extension().sparse_adagrad_cached_apply(cache_rows, cache_accum, slots,
                                            uids, grads, float(lr),
                                            float(eps))
    return cache_rows, cache_accum


def gather_rows_cached_cuda(cache_rows, slots, *, drop_row=False):
    """``out[i] = cache_rows[slots[i]]`` by one kernel launch on the current
    stream; with ``drop_row`` the output has one more row, zero (the
    working set's drop row).  The caller passes ``0 <= slots < C`` (the
    cache tier does: its pull's slots are all live, its lookup's misses
    read slot 0); the kernel writes a zero row for a slot outside that
    range."""
    _check_cuda(cache_rows, "gather_rows_cached_cuda")
    return extension().gather_rows_cached(cache_rows, slots, bool(drop_row))


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
