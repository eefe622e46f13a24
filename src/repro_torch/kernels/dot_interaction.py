"""DLRM's dot interaction on the card: the CUDA kernel's wrapper.

Counterpart of ``repro/kernels/dot_interaction.py::dot_interaction_pallas``;
the kernel is ``csrc/dot_interaction.cu`` (its header states the
arithmetic, what bounds it and its design).  ``feats`` (B, F, D) float32 or
bfloat16 gives ``(B, F (F - 1) / 2)`` in the same dtype: column p is the
dot of features ``(li[p], lj[p]) = np.tril_indices(F, k=-1)``, summed in
float32.

No host sync and no host-to-device copy per call: the wrapper checks the
input from its metadata only, the kernel derives each pair from its column
in closed form, and the output is allocated on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import extension

DTYPES = (torch.float32, torch.bfloat16)


def _check(feats: torch.Tensor) -> None:
    if not feats.is_cuda:
        raise ValueError(f"dot_interaction_cuda takes a CUDA tensor, got "
                         f"{feats.device}")
    if feats.dtype not in DTYPES:
        raise ValueError(f"dot_interaction_cuda takes float32 or bfloat16, "
                         f"got {feats.dtype}")
    if feats.dim() != 3:
        raise ValueError(f"feats must be (B, F, D), got {tuple(feats.shape)}")
    if feats.shape[1] < 1:
        raise ValueError("feats must have at least one feature")
    if not feats.is_contiguous():
        raise ValueError("dot_interaction_cuda takes a contiguous tensor")


def dot_interaction_cuda(feats: torch.Tensor) -> torch.Tensor:
    """The interaction of ``feats`` by one kernel launch on the current
    stream (none when the output is empty: ``B == 0`` or ``F == 1``).  The
    kernel takes up to 6144 features (the binding raises above)."""
    _check(feats)
    B, F, _ = feats.shape
    out = torch.empty((B, F * (F - 1) // 2), dtype=feats.dtype,
                      device=feats.device)
    if out.numel():
        extension().dot_interaction(feats, out)
    return out
