"""Embedding bag over the pulled working set: the hand-written CUDA kernel.

``out[b] = sum_{j: seg[j]==b} w[j] * working[inv[j]]``, with ``seg`` in any
order.  Counterpart of ``repro/kernels/embedding_bag.py::embedding_bag_pallas``;
the kernel is ``csrc/embedding_bag.cu`` (its header says how it is laid out
and what bounds it) and ``csrc/bindings.cpp`` binds it.

The wrapper prepares the index stream with PyTorch ops: a stable sort of
``seg`` gives each bag's entries in ascending original position (``order``)
and the per-bag CSR ``offsets``.  Entries whose ``seg`` lies outside
[0, num_bags) fall outside every bag's range and are dropped, as the
reference's segment sum drops them.  ``inv`` must index rows of
``working``; on the working-set path it does by construction (the drop row
is the last row).

The extension is built at first use, never on import: the CPU tests import
this module on machines without ``nvcc``.
"""

from __future__ import annotations

import os
import pathlib

import torch

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_REPO = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build" / "torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_ext = None


def extension():
    """The compiled kernels (built into ``build/torch_kernels/`` on first
    call; ``torch.utils.cpp_extension.load`` reuses an unchanged build)."""
    global _ext
    if _ext is None:
        from torch.utils.cpp_extension import load

        os.makedirs(BUILD_DIR, exist_ok=True)
        _ext = load(
            name="repro_torch_kernels",
            sources=[str(_CSRC / "bindings.cpp"),
                     str(_CSRC / "embedding_bag.cu")],
            build_directory=str(BUILD_DIR),
            extra_cflags=["-O3"],
            extra_cuda_cflags=CUDA_FLAGS,
            verbose=False,
        )
    return _ext


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


def csr_from_segments(seg, num_bags):
    """(order, offsets): entries of bag b are ``order[offsets[b]:offsets[b+1]]``
    in ascending original position."""
    sorted_seg, order = torch.sort(seg, stable=True)
    bounds = torch.arange(num_bags + 1, dtype=seg.dtype, device=seg.device)
    return order, torch.searchsorted(sorted_seg, bounds)


def launch(working, inv, weights, order, offsets, num_bags):
    """One launch of the CUDA kernel on prepared CSR indices."""
    out = torch.empty((num_bags, working.shape[1]), dtype=working.dtype,
                      device=working.device)
    extension().embedding_bag_forward(working, inv, weights, order, offsets,
                                      out)
    return out


def embedding_bag_cuda(working, inv, seg, weights, num_bags):
    """The bag on CUDA tensors: index preparation, then one kernel launch.
    Raises for tensors that are not on a CUDA device, or not contiguous."""
    _check_inputs(working, inv, seg, weights, num_bags)
    if not working.is_cuda:
        raise ValueError(
            f"embedding_bag_cuda takes CUDA tensors, got {working.device}")
    tensors = [working, inv, seg] + ([weights] if weights is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("embedding_bag_cuda takes contiguous tensors")
    order, offsets = csr_from_segments(seg, int(num_bags))
    return launch(working, inv, weights, order, offsets, int(num_bags))
