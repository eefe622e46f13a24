"""Model building blocks shared by the model families.

Counterpart of the parts of ``repro/models/common.py`` the CTR model and
the LM use.
Weights keep the reference's ``x @ w`` layout: a dense layer's ``w`` is an
``(in, out)`` matrix, so weights exported from the reference load as they
are.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import resolve_device


def he_init(generator: torch.Generator, shape, dtype=torch.float32,
            device="cuda", fan_in: Optional[int] = None) -> torch.Tensor:
    """He-normal weights on ``device`` (CUDA unless the caller asks for the
    CPU; ``generator`` must live there): a float32 draw times
    ``sqrt(2 / fan_in)``, cast to ``dtype``; ``fan_in`` defaults to
    ``shape[-2]`` (``shape[-1]`` for a vector)."""
    fan = fan_in if fan_in is not None else (
        shape[-2] if len(shape) >= 2 else shape[-1])
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


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The reference's three roundings: the variance in float32, its
    ``rsqrt`` cast to x's dtype, then ``x * inv * scale`` in x's dtype."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    two halves of the head (not interleaved pairs), in float32, then casts
    back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]                  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
