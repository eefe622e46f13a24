"""DLRM's dot interaction on the card: the CUDA kernels' wrappers.

Forward: counterpart of
``repro/kernels/dot_interaction.py::dot_interaction_pallas``; the kernel is
``csrc/dot_interaction.cu`` (its header states the arithmetic, what bounds
it and its design).  ``feats`` (B, F, D) float32 or bfloat16 gives
``(B, F (F - 1) / 2)`` in the same dtype: column p is the dot of features
``(li[p], lj[p]) = np.tril_indices(F, k=-1)``, summed in float32.

Backward (kernel 8b, the same file): ``g`` (B, F (F - 1) / 2) and ``feats``
give ``(G + G^T) feats``, G being ``g`` in the strict lower triangle, in
the same dtype, summed in float32 in a fixed order.  The reference has no
TPU kernel for it (it takes XLA's vjp of the jnp interaction).

No host sync and no host-to-device copy per call: the wrappers check the
inputs from their metadata only, the kernels derive each pair in closed
form, and the outputs are allocated on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import extension

DTYPES = (torch.float32, torch.bfloat16)


def _check(feats: torch.Tensor, what: str = "dot_interaction_cuda") -> None:
    if not feats.is_cuda:
        raise ValueError(f"{what} takes a CUDA tensor, got {feats.device}")
    if feats.dtype not in DTYPES:
        raise ValueError(f"{what} takes float32 or bfloat16, got "
                         f"{feats.dtype}")
    if feats.dim() != 3:
        raise ValueError(f"feats must be (B, F, D), got {tuple(feats.shape)}")
    if feats.shape[1] < 1:
        raise ValueError("feats must have at least one feature")
    if not feats.is_contiguous():
        raise ValueError(f"{what} takes a contiguous tensor")


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


def dot_interaction_backward_cuda(g: torch.Tensor,
                                  feats: torch.Tensor) -> torch.Tensor:
    """The interaction's gradient with respect to ``feats``, ``(G + G^T)
    feats``, by one kernel launch on the current stream (none when the
    output is empty).  ``g`` must be contiguous, on ``feats``' device and
    of its dtype (the autograd function makes a sliced gradient
    contiguous)."""
    what = "dot_interaction_backward_cuda"
    _check(feats, what)
    B, F, _ = feats.shape
    P = F * (F - 1) // 2
    if (g.device != feats.device or g.dtype != feats.dtype
            or tuple(g.shape) != (B, P)):
        raise ValueError(f"{what}: g must be ({B}, {P}) {feats.dtype} on "
                         f"{feats.device}, got {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    if not g.is_contiguous():
        raise ValueError(f"{what} takes a contiguous g")
    out = torch.empty_like(feats)
    if out.numel():
        extension().dot_interaction_backward(g, feats, out)
    return out
