"""PyTorch port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; every module here keeps the
path and names of its counterpart there.  This package imports ``torch``,
``numpy`` and the standard library only.  Its entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``; without CUDA
they raise.  See README.md for what has been ported so far.
"""


def resolve_device(device) -> "torch.device":
    """``device`` as a ``torch.device``; raises for CUDA when there is none
    (the port never moves to the CPU on its own)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts, lists and tuples (the
    parameter trees the reference keeps as JAX pytrees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
