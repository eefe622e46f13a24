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


class _EmbedLookup(torch.autograd.Function):
    """``table[ids]`` whose backward scatter-adds the gradient into a zero
    table in the table's dtype (the reference's ``_embed_lookup_bwd``)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return table.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + (table.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        D = ctx.table_shape[-1]
        dt = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        dt.index_add_(0, ids.reshape(-1), g.reshape(-1, D))
        return dt, None


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` -> ``ids.shape + (D,)``, differentiable in ``table``
    (the reference's ``sharded_embed_lookup``; no mesh on one card)."""
    return _EmbedLookup.apply(table, ids)


class _SoftmaxCrossEntropy(torch.autograd.Function):
    """The reference's ``softmax_cross_entropy`` with a hand-written vjp.

    Forward, in float32: ``m = max(logits)`` (no gradient), ``logz =
    log(sum exp(logits - m)) + m``, ``gold = (logits - m)[label] + m``,
    ``loss = logz - gold``.  It keeps the logits as they came (their
    dtype) and ``logz`` (float32); the backward forms ``g (softmax -
    onehot)`` from them in one float32 ``(T, V)`` buffer, where autograd
    of the plain ops would keep four, and casts it to the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels):
        x = logits.to(torch.float32)
        m = x.amax(-1, keepdim=True)
        shifted = x - m
        del x
        gold = shifted.gather(-1, labels[..., None]) + m
        logz = torch.log(shifted.exp_().sum(-1, keepdim=True)) + m
        del shifted
        ctx.save_for_backward(logits, labels, logz)
        return (logz - gold)[..., 0]

    @staticmethod
    def backward(ctx, g):
        logits, labels, logz = ctx.saved_tensors
        p = logits.to(torch.float32, copy=True)
        p.sub_(logz).exp_()
        p.scatter_add_(-1, labels[..., None],
                       torch.full(labels.shape + (1,), -1.0,
                                  dtype=torch.float32, device=p.device))
        p.mul_(g.to(torch.float32)[..., None])
        return p.to(logits.dtype), None


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Token-level cross-entropy, logits (..., V) any dtype -> (...)
    float32 (the reference's ``softmax_cross_entropy``)."""
    return _SoftmaxCrossEntropy.apply(logits, labels.to(torch.int64))
