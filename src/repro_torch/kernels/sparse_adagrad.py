"""The working-set AdaGrad push: its row arithmetic and the CUDA kernel.

Counterpart of ``repro/kernels/sparse_adagrad.py``.  ``adagrad_row_updates``
is the AdaGrad row math, computed once with PyTorch ops and shared by the
kernel and the plain version, so both receive the same ``(delta, g2)``
bits; ``sparse_adagrad_apply_cuda`` launches ``csrc/sparse_adagrad.cu``,
which adds them into the table and the accumulator in place (its header
states the ``uids`` layout it relies on and how it treats the pads).

The table and the accumulator are updated in place, the port's counterpart
of the reference's buffer donation (``input_output_aliases``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import extension


def adagrad_row_updates(accum_rows, grads, table_dtype, *, lr, eps):
    """``(delta, g2)`` with ``g2 = g^2`` and
    ``delta = -lr * g / (sqrt(accum_rows + g2) + eps)`` cast to the table
    dtype, one op per line in the reference's order.

    PyTorch runs each op on its own, so nothing is fused or contracted and
    the same bits feed the kernel and the plain version.  (The reference's
    XLA fusion recomputes ``a + g*g`` inside its fusion; its ``delta`` can
    differ from this one by a couple of ulps.)
    """
    g = grads.to(torch.float32)
    g2 = torch.square(g)
    a_new = accum_rows + g2
    delta = -lr * g / (torch.sqrt(a_new) + eps)
    return delta.to(table_dtype), g2


def _check_push(table, accum, uids, delta, g2):
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
        raise ValueError(
            f"sparse_adagrad_apply_cuda takes CUDA tensors, got {table.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sparse_adagrad_apply_cuda takes contiguous tensors")


def sparse_adagrad_apply_cuda(table, accum, uids, delta, g2):
    """``table[uids] += delta; accum[uids] += g2`` in place by one kernel
    launch on the current stream; returns the same ``(table, accum)``
    tensors.  ``uids`` as ``pull_working_set`` lays them out."""
    _check_push(table, accum, uids, delta, g2)
    extension().sparse_adagrad_apply(table, accum, uids, delta, g2)
    return table, accum
