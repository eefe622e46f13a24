"""Plain PyTorch versions of the kernels (the correctness contracts).

Counterpart of ``repro/kernels/ref.py``.  The CPU path runs these, and the
card checks each hand-written kernel against them.
"""

from __future__ import annotations

import torch


def embedding_bag_ref(working, inv, seg, weights, num_bags):
    """out[b] = sum_{j: seg[j]==b} w[j] * working[inv[j]] (seg in any order).

    On the CPU the scatter adds in ascending j, the order of the reference's
    ``jax.ops.segment_sum``; segments outside [0, num_bags) are dropped, as
    there.
    """
    emb = working.index_select(0, inv.long())
    if weights is not None:
        emb = emb * weights[:, None].to(working.dtype)
    return _segment_sum(emb, seg, num_bags)


def embedding_bag_backward_ref(g, working, inv, seg, weights,
                               need_working=True, need_weights=False):
    """The vjp of ``embedding_bag_ref`` (PyTorch's autograd through its index
    ops): ``(g_work, g_w)``, each None where it is not needed.  On the CPU
    the working-row scatter (``index_add_``) adds in ascending entry order;
    on the card it adds with float atomics, in no fixed order."""
    g_work = g_w = None
    need_weights = need_weights and weights is not None
    with torch.enable_grad():
        wk = working.detach().requires_grad_(need_working)
        w = weights
        if need_weights:
            w = weights.detach().requires_grad_(True)
        out = embedding_bag_ref(wk, inv, seg, w, g.shape[0])
        wrt = [t for t, need in ((wk, need_working), (w, need_weights))
               if need]
        if wrt:
            grads = torch.autograd.grad(out, wrt, g)
            g_work = grads[0] if need_working else None
            g_w = grads[-1] if need_weights else None
    return g_work, g_w


def _segment_sum(x, seg, num_bags):
    """Row j of ``x`` added into row seg[j]; out-of-range segments land in a
    spare row that is cut off."""
    seg = seg.long()
    idx = torch.where((seg >= 0) & (seg < num_bags), seg, num_bags)
    out = torch.zeros((num_bags + 1,) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    if x.dim() == 2:
        idx = idx[:, None].expand(-1, x.shape[1])
    return out.scatter_add_(0, idx, x)[:num_bags]


def bag_combiner_denom_ref(seg, num_bags, combiner, dtype):
    """Per-bag divisor for mean/sqrtn: the same expression on the kernel and
    the plain path (the division stays outside the kernel either way)."""
    cnt = _segment_sum(torch.ones(seg.shape, dtype=dtype, device=seg.device),
                       seg, num_bags)
    denom = torch.clamp_min(cnt, 1.0)
    if combiner == "sqrtn":
        denom = torch.sqrt(denom)
    return denom


def embedding_bag_combiner_ref(working, inv, seg, weights, num_bags, combiner):
    out = embedding_bag_ref(working, inv, seg, weights, num_bags)
    if combiner == "sum":
        return out
    if combiner not in ("mean", "sqrtn"):
        raise ValueError(f"unknown combiner: {combiner!r}")
    denom = bag_combiner_denom_ref(seg, num_bags, combiner, working.dtype)
    return out / denom[:, None]


def sparse_adagrad_apply_ref(table, accum, uids, delta, g2):
    """The push of precomputed ``(delta, g2)`` rows, in place:
    ``table[uids] += delta; accum[uids] += g2`` by ``index_add_``, returning
    the same two tensors.  The pads of ``pull_working_set``'s layout repeat
    ``uids[0]`` with ``delta = -0.0`` and ``g2 = +0.0``, which leave the row's
    bits unchanged in any order of the adds."""
    idx = uids.long()
    table.index_add_(0, idx, delta.to(table.dtype))
    accum.index_add_(0, idx, g2)
    return table, accum


def gather_rows_cached_ref(cache_rows, slots, drop_row=False):
    """``out[i] = cache_rows[slots[i]]``: the cached pull's row gather; with
    ``drop_row`` a zero row appended (the working set's drop row)."""
    out = cache_rows.index_select(0, slots.long())
    if drop_row:
        out = torch.cat([out, out.new_zeros((1, out.shape[1]))])
    return out


def hash_lookup_ref(key_tab, slot_tab, slot_uid, uids):
    """The batch linear probe, the plain version of ``hash_lookup_cuda``:
    ``slots[i]`` = the live cache slot of ``uids[i]`` (an entry ``(k, s)``
    is live iff ``slot_uid[s] == k``), or -1.

    Rounds over the batch as in the reference: every id still probing
    advances one bucket per round until it has seen its key (at most one
    bucket holds it) or an EMPTY bucket.  At most H rounds: an id that has
    seen neither by then (a map with no EMPTY bucket on its chain) gets -1,
    as from the kernel.
    """
    from repro_torch.kernels.hash_map import EMPTY, hash_bucket

    H = key_tab.shape[0]
    slot = torch.full(uids.shape, -1, dtype=torch.int32, device=uids.device)
    idx = torch.arange(uids.shape[0], device=uids.device)
    u = uids
    b = hash_bucket(uids, H).to(torch.int64)
    for _ in range(H):
        if not idx.numel():
            break
        kb = key_tab[b]
        found = kb == u
        s = slot_tab[b[found]].long()
        live = slot_uid[s] == u[found]
        slot[idx[found][live]] = s[live].to(torch.int32)
        active = ~found & (kb != EMPTY)
        idx, u, b = idx[active], u[active], (b[active] + 1) & (H - 1)
    return slot


def fused_adam_ref(params, grads, m, v_local, v_hat, *, t, lr, b1, b2, k,
                   local_v_warmup, mhat_s=None, vhat_s=None,
                   weight_decay=0.0):
    """The k-step local Adam step (Algorithm 2 lines 5-9) over lists of
    leaves, in place: the plain version of ``fused_adam_cuda``.  A param
    and its gradient are float32 or bfloat16 (widened to float32, p
    written back rounded to its dtype), the moments float32.

    ``m = b1*m + (1-b1)*g``; ``v_local = b2*v_local + (1-b2)*g^2``;
    ``p -= lr*(m*mhat_s) / sqrt(v_use*vhat_s) (+ lr*weight_decay*p)``, where
    ``v_use`` is the new ``v_local`` while ``local_v_warmup`` holds and
    ``t <= k`` (before the first merge), else ``v_hat``.  ``t`` is the step
    count after this step (a 0-dim int32 tensor), ``lr`` a Python float or
    a 0-dim float32 tensor, ``mhat_s``/``vhat_s`` the bias-correction
    factors as 0-dim float32 tensors (None: no correction).  These are the
    operations of ``core/kstep.py``'s local branch, one rounding each, in
    its order.
    """
    for p, g, mm, vv, vh in zip(params, grads, m, v_local, v_hat):
        g32 = g.to(torch.float32)
        m_new = b1 * mm + (1.0 - b1) * g32
        vl_new = b2 * vv + (1.0 - b2) * torch.square(g32)
        if local_v_warmup:
            v_use = torch.where(t <= k, vl_new, vh)
        else:
            v_use = vh
        m_use = m_new if mhat_s is None else m_new * mhat_s
        v_use = v_use if vhat_s is None else v_use * vhat_s
        d = lr * m_use / torch.sqrt(v_use)
        if weight_decay > 0.0:
            d = d + lr * weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - d)
        mm.copy_(m_new)
        vv.copy_(vl_new)
    return params, m, v_local


def sparse_adagrad_ref(rows, accum, grads, lr, eps):
    """The staged push over pulled ``(C, D)`` rows, in place: the plain
    version of ``sparse_adagrad_staged_cuda``.  ``(delta, g2)`` from
    ``adagrad_row_updates`` (the port's host push's row math), then
    ``rows += delta; accum += g2``; returns the same two tensors.  Row i
    ends bit-equal to row ``uids[i]`` of a table the host push updated."""
    from repro_torch.kernels.sparse_adagrad import adagrad_row_updates

    delta, g2 = adagrad_row_updates(accum, grads, rows.dtype, lr=lr, eps=eps)
    rows.add_(delta)
    accum.add_(g2)
    return rows, accum


def dot_interaction_ref(feats):
    """DLRM's dot interaction: the strict lower triangle of each instance's
    self-Gram, ``(B, F, D) -> (B, F (F - 1) / 2)`` in
    ``np.tril_indices(F, k=-1)`` order, summed in float32 and cast back to
    the input dtype."""
    F = feats.shape[1]
    f = feats.to(torch.float32)
    z = torch.einsum("bfd,bgd->bfg", f, f)
    li, lj = torch.tril_indices(F, F, offset=-1, device=feats.device)
    return z[:, li, lj].to(feats.dtype)



def dot_interaction_backward_ref(g, feats):
    """The interaction's gradient with respect to ``feats``: ``g``
    (B, F (F - 1) / 2) scattered into the strict lower triangle of a
    (B, F, F) float32 matrix G, then ``(G + G^T) feats`` by a float32
    ``einsum``, cast back to ``feats``' dtype.  The plain version of
    ``dot_interaction_backward_cuda``."""
    B, F, _ = feats.shape
    li, lj = torch.tril_indices(F, F, offset=-1, device=feats.device)
    m = torch.zeros((B, F, F), dtype=torch.float32, device=feats.device)
    m[:, li, lj] = g.to(torch.float32)
    m = m + m.transpose(1, 2)
    return torch.einsum("bij,bjd->bid", m,
                        feats.to(torch.float32)).to(feats.dtype)

def attention_mask(S, causal=True, window=None, chunk=None, device=None):
    """(S, S) bool, True where query row r may see key column c: c <= r
    under causal, ``r - c < window`` with a window, ``r // chunk == c //
    chunk`` with a chunk (the reference model's ``_mask`` on positions
    ``0..S-1``); None when nothing is masked."""
    if not causal and window is None and chunk is None:
        return None
    pos = torch.arange(S, device=device)
    r, c = pos[:, None], pos[None, :]
    m = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        m &= c <= r
    if window is not None:
        m &= (r - c) < window
    if chunk is not None:
        m &= (r // chunk) == (c // chunk)
    return m


def _scores(q, k, causal, window, chunk):
    """(B, Kv, G, S, S) float32 scaled, masked scores, and q's shape."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    qg = (q.to(torch.float32) * (1.0 / hd ** 0.5)).reshape(B, S, Kv,
                                                            H // Kv, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    m = attention_mask(S, causal, window, chunk, q.device)
    if m is not None:
        s.masked_fill_(~m, -1e30)
    return s


def flash_attention_ref(q, k, v, causal=True, window=None, chunk=None):
    """Softmax attention in the model's layout, in one pass: q (B, S, H, hd),
    k and v (B, S, Kv, hd) -> (B, S, H, hd) in q's dtype, q head h reading
    KV head ``h // (H // Kv)``, under ``attention_mask(S, causal, window,
    chunk)``.

    The arithmetic of the TPU kernel's body (``_flash_kernel``) over the
    whole kv axis at once: q widened and scaled by ``1/sqrt(hd)`` in
    float32, float32 scores, masked scores ``-1e30``, ``p = exp(s - max)``,
    ``(p @ v) / max(sum p, 1e-30)`` in float32, one cast back.  The max is
    taken without a gradient (the softmax does not depend on it), so
    autograd differentiates the rest, through the in-place steps.
    """
    B, S, H, hd = q.shape
    s = _scores(q, k, causal, window, chunk)
    # in place: the (B, Kv, G, S, S) scores are the one large buffer
    p = s.sub_(s.amax(-1, keepdim=True).detach()).exp_()
    o = torch.einsum("bkgst,btkd->bkgsd", p, v.to(torch.float32))
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def flash_attention_lse_ref(q, k, causal=True, window=None, chunk=None):
    """The rows' log-sum-exp of ``flash_attention_ref``'s scaled, masked
    float32 scores, (B, H, S) float32: what ``flash_attention_cuda(...,
    return_lse=True)`` returns beside the output."""
    B, S, H, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal, window, chunk),
                           -1).reshape(B, H, S)


def flash_attention_backward_ref(q, k, v, dout, causal=True, window=None,
                                 chunk=None):
    """``(dq, dk, dv)``, the plain vjp of ``flash_attention_ref`` for the
    output gradient ``dout`` (autograd through it, in float32 inside, each
    gradient in its input's dtype): the plain version of
    ``flash_attention_backward_cuda``."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = flash_attention_ref(*xs, causal, window, chunk)
        return torch.autograd.grad(out, xs, dout)
