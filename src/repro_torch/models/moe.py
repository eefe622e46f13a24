"""Mixture-of-Experts FFN: ``repro/models/moe.py``'s capacity routing.

Tokens are bucketed into ``G`` groups of ``gsz`` (``cfg.moe_group_size``,
at most all the tokens); each group routes its tokens to ``top_k`` of
``E`` experts, each expert taking at most ``C`` tokens of a group (its
capacity), and the experts' swish-gated FFNs run over every capacity slot
as three batched products.  The reference vmaps its per-group functions;
here they run batched over the ``G`` groups, with its arithmetic and
roundings:

- Router: ``x @ router`` in the model dtype, widened to float32; softmax
  and the top-k in float32 (the top-k by ``k`` rounds of ``argmax``, which
  takes the lowest index of tied maxima, as ``lax.top_k`` does); the top-k
  weights renormalised with the ``1e-9`` floor, then cast to the model
  dtype.
- Priority: every first choice claims capacity before any second choice,
  in token order (the one-hot cumsum).
- Capacity: ``max(top_k, int(gsz top_k capacity_factor / E))``, padded up
  to a multiple of 8 and capped at ``gsz top_k``; a choice past its
  expert's capacity is dropped to the dump slot ``E C``.
- Combine: each choice adds ``row (w keep)``, in the model dtype, into a
  zero output in the model dtype; a dropped choice reads a zero row.
- Aux loss: ``E sum(frac mean_p)`` per group, averaged over the groups;
  computed only where the caller asks for it (the trunk; decode drops it).

Layout: the dispatch buffer is ``(E, G C, D)`` plus one dump row, so each
expert's slots of every group are one contiguous matrix and the three
products are ``bmm`` over the experts with no copy (the reference's
``(G, E, C, D)`` einsums).  A choice's ``row`` of the buffer, which both
the dispatch and the combine index, is ``e G C + g C + pos``: the
reference's per-group slot ``e C + pos`` (dump ``E C``) spread over the
groups.

Nothing is read on the host and no shape depends on the data (no
``nonzero``, no boolean indexing, no ``.item()``), so ``decode_step``
stays free of host syncs.

Determinism on the card: the dispatch writes each kept slot once; only the
dump row takes duplicate writes, and it is never read.  The combine adds
``top_k`` contributions to each token's row, which starts as an exact zero:
with ``top_k <= 2`` the sum is ``0 + a + b``, the same bits in either
order, so the combine is bit-reproducible even with atomic adds.  So is
the backward, autograd through the same ops: ``index_add_``'s backward
gathers each choice's row once; ``index_select``'s backward adds into a
zero buffer one term a kept buffer row (each is gathered by one choice)
and many onto the dump row, whose gradient is discarded;
``index_copy_``'s backward gathers, and the ``repeat``'s backward sums
the ``top_k`` copies in a fixed order.

Training: the backward is autograd's, as the reference's is ``jax.grad``.
The aux loss's gradient flows through ``probs`` alone (``frac`` is a
count); a dropped choice's weight is multiplied by ``keep = 0``, so it
gets none; top-1 renormalises its weight to exactly 1, so the router's
gradient is the aux loss's alone, up to rounding, in both packages.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class Plan(NamedTuple):
    """A routing plan, batched over the ``G`` groups; ``n = top_k gsz``
    choices a group, first choices first."""
    t_flat: torch.Tensor   # (n,) int64: each choice's token in its group
    w_flat: torch.Tensor   # (G, n) model dtype: renormalised router weight
    keep: torch.Tensor     # (G, n) bool: the choice fit its capacity
    row: torch.Tensor      # (G, n) int64: its row of the (E, G C) buffer,
                           # e G C + g C + pos, or E G C (the dump row)


def capacity(gsz: int, E: int, top_k: int, capacity_factor: float) -> int:
    """Slots an expert takes from a group of ``gsz`` tokens."""
    c = max(top_k, int(gsz * top_k * capacity_factor / E))
    return min(gsz * top_k, -(-c // 8) * 8)


def groups(T: int, group_size: int):
    """``(gsz, G)`` for ``T`` tokens; raises unless ``gsz`` divides T."""
    gsz = min(group_size, T)
    if T % gsz:
        raise ValueError(f"tokens {T} not divisible by moe group {gsz}")
    return gsz, T // gsz


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: values descending, ties to the
    lower index, by ``k`` rounds of ``argmax``."""
    p = probs.clone() if k > 1 else probs
    vals, idx = [], []
    for _ in range(k):
        i = torch.argmax(p, dim=-1, keepdim=True)
        vals.append(probs.gather(-1, i))
        idx.append(i)
        if k > 1:
            p.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idx, -1)


def route(xg: torch.Tensor, wr: torch.Tensor, E: int, top_k: int,
          cap: int, with_aux: bool = False
          ) -> Tuple[Plan, Optional[torch.Tensor]]:
    """The reference's ``_route_group`` for every group: xg (G, gsz, D),
    the router wr (D, E) -> (plan, aux): aux (G,) float32, each group's
    load-balance loss, with ``with_aux``, else None."""
    G, S, _ = xg.shape
    logits = (xg @ wr).to(torch.float32)                     # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    gv, gi = _top_k(probs, top_k)                            # (G, S, k)
    gv = gv / gv.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = gi.transpose(1, 2).reshape(G, top_k * S)        # first choices first
    w_flat = gv.transpose(1, 2).reshape(G, top_k * S)
    t_flat = torch.arange(S, device=xg.device).repeat(top_k)
    onehot = (e_flat[..., None] == torch.arange(E, device=xg.device)).to(
        torch.int64)                                          # (G, n, E)
    pos_in_e = torch.cumsum(onehot, dim=1).gather(
        2, e_flat[..., None])[..., 0] - 1
    keep = pos_in_e < cap
    g = torch.arange(G, device=xg.device)[:, None]
    row = torch.where(keep, e_flat * (G * cap) + g * cap + pos_in_e,
                      E * G * cap)
    aux = None
    if with_aux:
        frac = onehot.to(torch.float32).mean(1) * top_k      # (G, E)
        aux = E * (frac * probs.mean(1)).sum(-1)
    return Plan(t_flat, w_flat.to(xg.dtype), keep, row), aux


def dispatch(xg: torch.Tensor, plan: Plan, E: int, cap: int) -> torch.Tensor:
    """The reference's ``_dispatch_group`` for every group -> xe (E, G C,
    D): slot ``g C + pos`` of expert e holds its pos-th token of group g,
    zeros where none came."""
    G, S, D = xg.shape
    buf = torch.zeros((E * G * cap + 1, D), dtype=xg.dtype, device=xg.device)
    top_k = plan.row.shape[1] // S
    buf.index_copy_(0, plan.row.reshape(-1),
                    xg.repeat(1, top_k, 1).reshape(-1, D))
    return buf[:E * G * cap].view(E, G * cap, D)


def experts(xe: torch.Tensor, lp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The experts' swish-gated FFN over every slot: xe (E, G C, D) ->
    (E, G C, D), three products batched over the experts."""
    g = torch.bmm(xe, lp["we_gate"])
    u = torch.bmm(xe, lp["we_up"])
    return torch.bmm(F.silu(g) * u, lp["we_down"])


def combine(ye: torch.Tensor, plan: Plan, S: int) -> torch.Tensor:
    """The reference's ``_combine_group`` for every group: ye (E, G C, D)
    -> (G, S, D), each choice's row times ``w keep`` added to its token."""
    G = plan.row.shape[0]
    D = ye.shape[-1]
    flat = torch.cat([ye.reshape(-1, D), ye.new_zeros((1, D))])
    rows = flat.index_select(0, plan.row.reshape(-1))
    scale = (plan.w_flat * plan.keep.to(ye.dtype)).reshape(-1, 1)
    tok = (torch.arange(G, device=ye.device)[:, None] * S
           + plan.t_flat[None, :]).reshape(-1)
    out = torch.zeros((G * S, D), dtype=ye.dtype, device=ye.device)
    return out.index_add_(0, tok, rows * scale).view(G, S, D)


def moe_ffn(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg,
            with_aux: bool = True):
    """x (B, S, D) post-norm activations -> (y (B, S, D), aux_loss 0-dim
    float32, or None without ``with_aux``).  ``lp`` holds router (D, E),
    we_gate and we_up (E, D, F), we_down (E, F, D) and, with ``cfg.shared_expert``, ws_gate, ws_up
    (D, F) and ws_down (F, D)."""
    B, S, D = x.shape
    E, top_k = cfg.n_experts, cfg.top_k
    T = B * S
    gsz, G = groups(T, cfg.moe_group_size)
    cap = capacity(gsz, E, top_k, cfg.capacity_factor)
    xg = x.reshape(G, gsz, D)
    plan, aux = route(xg, lp["router"], E, top_k, cap, with_aux)
    ye = experts(dispatch(xg, plan, E, cap), lp)
    y = combine(ye, plan, gsz).reshape(B, S, D)
    if cfg.shared_expert:
        xt = x.reshape(T, D)
        sg = F.silu(xt @ lp["ws_gate"]) * (xt @ lp["ws_up"])
        y = y + (sg @ lp["ws_down"]).reshape(B, S, D)
    return y, (aux.mean() if with_aux else None)
