"""The k-step local Adam step over every leaf of the dense tower in one
launch: the CUDA kernel's wrapper.

Counterpart of ``repro/kernels/fused_adam.py::fused_adam_pallas``; the
kernel is ``csrc/fused_adam.cu`` (its header states the arithmetic, the
roundings that make it bit-equal to ``ref.fused_adam_ref`` on the card, and
what bounds it).  It updates the parameters, the first moment and the local
second moment in place.

No host sync and no host-to-device copy per step: the leaves' pointers and
sizes go into a host table (``AdamTable``) built once and kept while the
leaves' storage stays the same (the step updates in place, so it does); the
gradients' pointers, the Python-float scalars and that table travel by
value in the launch's parameters; the step count, a tensor ``lr`` and the
bias-correction factors are 0-dim device tensors read by pointer.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import extension

# a parameter and its gradient: either; the moments are float32
PARAM_DTYPES = (torch.float32, torch.bfloat16)


def _leaf_key(leaves):
    return tuple((x.data_ptr(), x.numel()) for x in leaves)


class AdamTable:
    """The (L, 6) int64 host table of the persistent leaves' pointers,
    sizes and dtypes: ``(p, m, v_local, v_hat, numel, p is bfloat16)`` per
    leaf.  ``get`` checks the
    leaves and builds it the first time, then returns the same table while
    the leaves' storage is unchanged (and builds a new one when it is not).
    The caller keeps the leaves alive while it uses the table."""

    def __init__(self):
        self._key = None
        self._table = None

    def get(self, params, m, v_local, v_hat) -> torch.Tensor:
        groups = (params, m, v_local, v_hat)
        key = tuple(_leaf_key(g) for g in groups)
        if key != self._key:
            self._table = _build_table(*groups)
            self._key = key
        return self._table


def _build_table(params, m, v_local, v_hat) -> torch.Tensor:
    n = len(params)
    if not (len(m) == len(v_local) == len(v_hat) == n):
        raise ValueError(f"params, m, v_local and v_hat hold {n}, {len(m)}, "
                         f"{len(v_local)} and {len(v_hat)} leaves")
    rows = []
    for i, leaf in enumerate(zip(params, m, v_local, v_hat)):
        p = leaf[0]
        for name, x in zip(("param", "m", "v_local", "v_hat"), leaf):
            ok = PARAM_DTYPES if name == "param" else (torch.float32,)
            if x.dtype not in ok or not x.is_cuda:
                raise ValueError(f"fused_adam_cuda takes float32 or bfloat16"
                                 f" CUDA params and float32 CUDA moments; "
                                 f"{name} {i} is {x.dtype} on {x.device}")
            if x.device != p.device or x.shape != p.shape:
                raise ValueError(f"{name} {i} is {tuple(x.shape)} on "
                                 f"{x.device}, its param {tuple(p.shape)} on "
                                 f"{p.device}")
            if not x.is_contiguous():
                raise ValueError(f"fused_adam_cuda takes contiguous leaves; "
                                 f"{name} {i} is not")
        if len({x.data_ptr() for x in leaf}) != 4 and p.numel():
            raise ValueError(f"leaf {i}: param, m, v_local and v_hat must "
                             "not share storage")
        rows.append([x.data_ptr() for x in leaf]
                    + [p.numel(), int(p.dtype == torch.bfloat16)])
    return torch.tensor(rows, dtype=torch.int64).reshape(n, 6)


def fused_adam_cuda(params, grads, m, v_local, v_hat, *, t, lr, b1, b2, k,
                    local_v_warmup, mhat_s=None, vhat_s=None,
                    weight_decay=0.0, table=None):
    """The local Adam step of ``ref.fused_adam_ref`` over lists of CUDA
    leaves, in place, by one kernel launch per 32 leaves on the current
    stream; returns ``(params, m, v_local)``.  A parameter and its gradient
    are float32 or bfloat16 (one dtype for both), the moments float32.

    ``t`` is the step count after this step (0-dim int32 on the leaves'
    device), ``lr`` a Python float or a 0-dim float32 tensor on that
    device, ``mhat_s``/``vhat_s`` 0-dim float32 tensors there or None.
    ``table``: an ``AdamTable`` the caller keeps across steps (None: a
    table for this call only).  Gradients that are not contiguous are
    copied to contiguous ones first.
    """
    table = (table if table is not None else AdamTable()).get(
        params, m, v_local, v_hat)
    if len(grads) != len(params):
        raise ValueError(f"{len(grads)} gradients for {len(params)} leaves")
    for i, (p, g) in enumerate(zip(params, grads)):
        if g.dtype != p.dtype:
            raise ValueError(f"gradient {i} is {g.dtype}, its param "
                             f"{p.dtype}")
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    lr_t = None
    if isinstance(lr, torch.Tensor):
        if lr.dim() != 0 or lr.dtype != torch.float32 or not lr.is_cuda:
            raise ValueError(f"a tensor lr must be 0-dim float32 on the "
                             f"card, got {tuple(lr.shape)} {lr.dtype} on "
                             f"{lr.device}")
        lr_t, lr = lr, 0.0
    extension().fused_adam(table, grads, t, lr_t, float(lr), mhat_s, vhat_s,
                           float(b1), float(b2), float(weight_decay), int(k),
                           bool(local_v_warmup))
    return params, m, v_local
