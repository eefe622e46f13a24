"""Payload compression primitives for cross-pod merges (beyond paper).

Counterpart of ``repro/core/compression.py``: symmetric per-tensor int8
quantization with an explicit scale, plus the error-feedback residual.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(x: torch.Tensor,
                  levels: int = 127) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (q int8, scale f32) with x ~= q * scale, |q| <= levels."""
    x32 = x.to(torch.float32)
    s = torch.max(torch.abs(x32)) / levels + 1e-30
    q = torch.clamp(torch.round(x32 / s), -levels, levels).to(torch.int8)
    return q, s


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantization_residual(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Error-feedback residual: the part of x the int8 payload failed to
    carry."""
    return x.to(torch.float32) - dequantize_int8(q, scale)
