"""Model building blocks shared by the model families.

Counterpart of the parts of ``repro/models/common.py`` the CTR model uses.
Weights keep the reference's ``x @ w`` layout: a dense layer's ``w`` is an
``(in, out)`` matrix, so weights exported from the reference load as they
are.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import resolve_device


def he_init(generator: torch.Generator, shape, dtype=torch.float32,
            device="cuda") -> torch.Tensor:
    """He-normal weights on ``device`` (CUDA unless the caller asks for the
    CPU; ``generator`` must live there)."""
    fan = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=resolve_device(device))
    return (w * (2.0 / fan) ** 0.5).to(dtype)


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             dtype=torch.float32, device="cuda"):
    """[{"w", "b"}] stack for a plain MLP with the given layer sizes, on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return [
        {"w": he_init(generator, (sizes[i], sizes[i + 1]), dtype,
                      device=device),
         "b": torch.zeros((sizes[i + 1],), dtype=dtype, device=device)}
        for i in range(len(sizes) - 1)
    ]


def mlp_apply(params, x, act=torch.relu):
    """The MLP in the reference's ``x @ w + b`` layout; ``act`` after every
    layer but the last."""
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = act(x)
    return x


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))
