"""Flash attention on the card: the CUDA kernels' wrappers, forward
(kernel 9) and backward (kernel 9b).

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_pallas``;
the kernels are in ``csrc/flash_attention.cu`` (the forward; its header
states the arithmetic, what bounds them and their design) and
``csrc/flash_attention_backward.cu`` (the backward).  The backward has no TPU
kernel: the reference takes XLA's vjp of its attention; 9b is
FlashAttention-2's backward from the forward's output and row
log-sum-exp, and its plain version is ``ref.flash_attention_backward_ref``
(autograd's vjp of ``ref.flash_attention_ref``).  They work in the model's
layout: q (B, S, H, hd), k and v (B, S, Kv, hd), contiguous, float32 or
bfloat16, q head h reading KV head ``h // (H // Kv)``, any S, hd a multiple
of 8 up to 256.  The dtype picks the kernel: bfloat16 runs on the tensor
cores (``flash_attention_mma_kernel``), float32 on the CUDA cores
(``flash_attention_kernel``).  The plain version is
``ref.flash_attention_ref``.  Both take the reference model's sliding
window and chunk (``window``, ``chunk``: key c is seen by row r only if
``r - c < window`` and ``r // chunk == c // chunk``, on top of causal),
validated once by ``local_terms``; the backward takes the forward's.

No host sync and no host-to-device copy per call: the wrapper checks the
inputs from their metadata only and allocates the output on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import extension

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_cuda takes CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"flash_attention_cuda takes float32 or "
                             f"bfloat16 q, k, v of one dtype, got {name} "
                             f"{t.dtype} with q {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda takes contiguous "
                             f"tensors, {name} is not")
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    if k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (B, S,
                                                                      hd):
        raise ValueError(f"k and v must be (B, S, Kv, hd) = ({B}, {S}, Kv, "
                         f"{hd}), got {tuple(k.shape)} and {tuple(v.shape)}")
    if Kv < 1 or H % Kv:
        raise ValueError(f"H ({H}) must be a multiple of Kv ({Kv})")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """``|got - want|`` in bfloat16 ulps of ``want``, element by element
    (float32).  An output row (the last dim) is a convex mix of v's rows;
    an element below 2^-8 of its row's largest magnitude is measured in the
    ulp at that magnitude: its own ulp would lie below 2^-16 of the row's
    scale, where two float32 computations of the row's sums in other orders
    already differ."""
    w = want.float()
    mag = torch.maximum(w.abs(), w.abs().amax(-1, keepdim=True) * 2.0 ** -8)
    exp = torch.frexp(mag.clamp_min(2.0 ** -126))[1] - 1
    return (got.float() - w).abs() / torch.ldexp(torch.ones_like(w), exp - 7)


def _rows(q: torch.Tensor) -> torch.Tensor:
    """A (B, H, S) float32 buffer of per-row statistics on q's device."""
    B, S, H, _ = q.shape
    return torch.empty((B, H, S), dtype=torch.float32, device=q.device)


def local_terms(causal: bool, window, chunk):
    """``(window, chunk)`` as the kernel takes them, 0 for none; raises for
    a term below 1 or one without causal.  A term of S or more masks
    nothing past causal: the kernel's first key is 0 on every row, so the
    bits are the causal kernel's."""
    terms = []
    for name, x in (("window", window), ("chunk", chunk)):
        if x is not None and (int(x) != x or x < 1):
            raise ValueError(f"{name} must be a positive int, got {x!r}")
        terms.append(0 if x is None else int(x))
    if any(terms) and not causal:
        raise ValueError("a window or a chunk needs causal=True (the "
                         "reference's mask is causal first)")
    return terms


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, return_lse: bool = False,
                         window=None, chunk=None):
    """The attention of ``q`` over ``k`` and ``v`` by one kernel launch on
    the current stream (none when the output is empty), under
    ``ref.attention_mask(S, causal, window, chunk)``.  With ``return_lse``
    returns ``(out, lse)``, lse (B, H, S) float32 the rows' log-sum-exp of
    their scaled, masked scores (what the backward takes); ``out`` is the
    same either way."""
    _check(q, k, v)
    w, c = local_terms(causal, window, chunk)
    out = torch.empty_like(q)
    lse = _rows(q) if return_lse else None
    if out.numel():
        extension().flash_attention(q, k, v, out, bool(causal), lse, w, c)
    return (out, lse) if return_lse else out


def flash_attention_backward_cuda(q, k, v, out, lse, dout, causal=True,
                                  window=None, chunk=None):
    """Kernel 9b: ``(dq, dk, dv)`` of the attention whose forward gave
    ``out`` and ``lse`` (``flash_attention_cuda(..., return_lse=True)``
    with the same ``causal``, ``window`` and ``chunk``), for the output
    gradient ``dout``, in the inputs' dtype, by three launches on the
    current stream (D = rowsum(dO o), then dK and dV, then dQ; none when
    the output is empty): bfloat16 on the tensor cores
    (``flash_attention_bwd_{kv,q}_mma_kernel``, P and dS rounded once to
    bfloat16 as the products' operands), float32 on the CUDA cores.  No
    atomics: two runs give the same bits."""
    _check(q, k, v)
    w, c = local_terms(causal, window, chunk)
    B, S, H, _ = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_cuda:
            raise ValueError(f"{name} must be q's shape and dtype on the "
                             f"card, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, H, S) = ({B}, {H}, {S}) float32, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    out, dout, lse = (t if t.is_contiguous() else t.contiguous()
                      for t in (out, dout, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel():
        extension().flash_attention_backward(q, k, v, out, dout, lse,
                                             _rows(q), dq, dk, dv,
                                             bool(causal), w, c)
    return dq, dk, dv
