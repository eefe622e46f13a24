"""Decoder-only LM family: ``repro/models/transformer.py``'s prefill,
decode and training loss.

Ported: GQA, qk-norm, QKV bias, RoPE, tied or untied embeddings, dense
and MoE FFNs (``models/moe.py``), the causal, sliding-window and chunked
masks (with ``global_every`` full layers); ``init_params``, ``trunk``,
``forward``, ``prefill`` and ``loss_fn``; ``_mask``, the masked dense
attention ``_sdpa_dense``, ``cache_len``, ``init_cache`` and
``decode_step``.  The no-cache branch of ``_attn_block`` (prefill and
training) is ``ops.flash_attention`` with the layer's window or chunk: the
hand-written CUDA kernels on the card (TPU kernel 9 forward, kernel 9b
backward, both under the layer's window or chunk), its plain version on
the CPU.  The MoE FFN's backward is autograd through ``models/moe.py``.

Training (``loss_fn``) follows the reference's memory plan: with grad
enabled, ``trunk`` recomputes each layer in the backward (a non-reentrant
``torch.utils.checkpoint`` per layer, the reference's ``nothing_saveable``
remat), so one layer's activations are live at a time; the head and the
cross-entropy run in the reference's token chunks, each under a
checkpoint, through ``common.softmax_cross_entropy``, whose hand-written
vjp keeps one float32 chunk of logits.  The embedding's backward is a
scatter-add in the table's dtype (``common.embed_lookup``).  Attention over a
KV cache (decode) is the reference's ``_sdpa_dense`` in plain PyTorch, as
in the reference (jnp, no Pallas kernel), with its roundings: the scores
leave the product in the model dtype and are widened to float32, scaled,
masked to -1e30 and softmaxed in float32, and p is rounded to the model
dtype before ``p @ v``.

Parameters keep the reference's tree and layout, so its exports load as
they are (``interop.lm_from_reference``): ``embed`` (vocab, d),
``layers[name]`` stacked with a leading L, ``final_norm``, ``head``
(d, vocab) unless tied, and ``x @ w`` weights.  Layers run as a Python loop
over the stacked leaves (the reference's ``lax.scan``); the mesh hints
(``shard_hint``, ``_whint``) have no counterpart on one card.

The KV cache is laid out ``(L, B, Kv, Skv, hd)``, not the reference's
``(L, B, Skv, Kv, hd)``: a layer's K and V are then ``B * Kv`` contiguous
``(Skv, hd)`` matrices, and ``q @ k^T`` and ``p @ v`` are batched products
over them with no copy (``interop.lm_cache_from_reference`` carries a
reference cache across).  ``decode_step`` updates the cache in place, the
port's counterpart of the reference jit's donation: one cache is live at a
time.  A windowed model's cache is a ring of ``attn_window`` slots.

Not ported yet, and raising ``NotImplementedError`` on every device:
sequence-sharded activations (A8).  The reference's attention-choice knobs
(``dense_attn_threshold``, ``attn_block_kv``, ``attn_block_q``) have no
field here: the port runs the flash kernels at every length, where the
reference takes ``_sdpa_dense`` or ``_sdpa_qblocked`` in training and
rounds p to the model dtype before ``p @ v`` (ROADMAP.md §C).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.common import (apply_rope, embed_lookup, he_init,
                                       rms_norm, softmax_cross_entropy)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: Optional[int] = None          # default d_model // n_heads
    rope_theta: float = 1e6
    qk_norm: bool = False                   # qwen3
    qkv_bias: bool = False                  # qwen2
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # Attention pattern: full | window (SWA, mixtral) | chunked (llama4 iRoPE)
    attn_window: Optional[int] = None       # sliding window size
    attn_chunk: Optional[int] = None        # local chunk size
    global_every: int = 0                   # with attn_chunk: every Nth layer full
    # MoE (0 experts = dense FFN)
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_group_size: int = 4096
    shared_expert: bool = False             # llama4 shared expert
    router_aux_coef: float = 0.0
    dtype: Any = torch.bfloat16
    ce_chunk_tokens: int = 65536  # global tokens per cross-entropy chunk
    seq_shard: bool = False       # sequence-sharded activations (A8)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def active_params(self) -> int:
        """Parameters touched per token (for MODEL_FLOPS = 6 * N_active * D)."""
        d, hd, H, Kv, L = self.d_model, self.hd, self.n_heads, self.n_kv_heads, self.n_layers
        attn = d * (H * hd) + 2 * d * (Kv * hd) + (H * hd) * d
        if self.n_experts:
            ffn = 3 * d * self.d_ff * self.top_k
            ffn += d * self.n_experts  # router
            if self.shared_expert:
                ffn += 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        embed = 0 if self.tie_embeddings else d * self.vocab
        return L * (attn + ffn) + d * self.vocab + embed

    def total_params(self) -> int:
        d, hd, H, Kv, L = self.d_model, self.hd, self.n_heads, self.n_kv_heads, self.n_layers
        attn = d * (H * hd) + 2 * d * (Kv * hd) + (H * hd) * d
        if self.n_experts:
            ffn = 3 * d * self.d_ff * self.n_experts + d * self.n_experts
            if self.shared_expert:
                ffn += 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        return L * (attn + ffn + 2 * d) + 2 * d * self.vocab + d


def _check_ported(cfg: TransformerConfig) -> None:
    """Raise for the config fields the port does not have yet."""
    if cfg.seq_shard:
        raise NotImplementedError(
            "sequence-sharded activations (seq_shard) are not ported yet: "
            "ROADMAP.md queue A8 (the multi-GPU exchange)")


# ----------------------------------------------------------------- params
def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device="cuda") -> Dict[str, Any]:
    """The reference's parameter tree on ``device`` (CUDA unless the caller
    asks for the CPU; ``generator`` must live there), with its
    distributions: He-normal weights with the reference's ``fan_in``, ones
    for the norms, zeros for the biases.  Stacked leaves are drawn layer by
    layer (the experts' one (layer, expert) matrix at a time), so the
    largest float32 temporary is one matrix."""
    _check_ported(cfg)
    device = resolve_device(device)
    d, hd, H, Kv, L, F = (
        cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.d_ff,
    )
    dt = cfg.dtype

    def stack(shape, fan_in, lead=(L,)):
        out = torch.empty(lead + shape, dtype=dt, device=device)
        for m in out.view((-1,) + shape):
            m.copy_(he_init(generator, shape, dt, device=device,
                            fan_in=fan_in))
        return out

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=device)

    layers: Dict[str, Any] = {
        "attn_norm": full((L, d), 1.0),
        "ffn_norm": full((L, d), 1.0),
        "wq": stack((d, H * hd), d),
        "wk": stack((d, Kv * hd), d),
        "wv": stack((d, Kv * hd), d),
        "wo": stack((H * hd, d), H * hd),
    }
    if cfg.qkv_bias:
        layers["bq"] = full((L, H * hd), 0.0)
        layers["bk"] = full((L, Kv * hd), 0.0)
        layers["bv"] = full((L, Kv * hd), 0.0)
    if cfg.qk_norm:
        layers["q_norm"] = full((L, hd), 1.0)
        layers["k_norm"] = full((L, hd), 1.0)
    if cfg.n_experts:
        E = cfg.n_experts
        layers["router"] = stack((d, E), d)
        layers["we_gate"] = stack((d, F), d, lead=(L, E))
        layers["we_up"] = stack((d, F), d, lead=(L, E))
        layers["we_down"] = stack((F, d), F, lead=(L, E))
        if cfg.shared_expert:
            layers["ws_gate"] = stack((d, F), d)
            layers["ws_up"] = stack((d, F), d)
            layers["ws_down"] = stack((F, d), F)
    else:
        layers["w_gate"] = stack((d, F), d)
        layers["w_up"] = stack((d, F), d)
        layers["w_down"] = stack((F, d), F)

    params = {
        "embed": he_init(generator, (cfg.vocab, d), dt, device=device,
                         fan_in=d),
        "layers": layers,
        "final_norm": full((d,), 1.0),
    }
    if not cfg.tie_embeddings:
        params["head"] = he_init(generator, (d, cfg.vocab), dt,
                                 device=device, fan_in=d)
    return params


# ------------------------------------------------------------------ layer
def _qkv(cfg, lp, x, q_pos):
    """The attention sublayer's inputs: rms_norm, the q, k, v projections
    (and biases), qk-norm and RoPE -> q (B,S,H,hd), k and v (B,S,Kv,hd)."""
    B, S, _ = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = h @ lp["wq"]
    kx = h @ lp["wk"]
    vx = h @ lp["wv"]
    if cfg.qkv_bias:
        q, kx, vx = q + lp["bq"], kx + lp["bk"], vx + lp["bv"]
    q = q.reshape(B, S, H, hd)
    kx = kx.reshape(B, S, Kv, hd)
    vx = vx.reshape(B, S, Kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        kx = rms_norm(kx, lp["k_norm"], cfg.norm_eps)
    pos = q_pos[None, :].expand(B, S)
    q = apply_rope(q, pos, cfg.rope_theta)
    kx = apply_rope(kx, pos, cfg.rope_theta)
    return q, kx, vx


# -------------------------------------------------------------- attention
def _is_global(cfg: TransformerConfig, layer_idx: int) -> bool:
    """A full-attention layer of a chunked model (every ``global_every``-th,
    the last of each run)."""
    return (cfg.global_every > 0
            and layer_idx % cfg.global_every == cfg.global_every - 1)


def _mask(cfg: TransformerConfig, layer_idx, q_pos, kv_pos):
    """(Sq, Skv) boolean mask from absolute positions (int32): causal, and
    within ``attn_window`` of the query, and in the query's
    ``attn_chunk`` unless the layer is global."""
    m = kv_pos[None, :] <= q_pos[:, None]
    if cfg.attn_window is not None:
        m &= (q_pos[:, None] - kv_pos[None, :]) < cfg.attn_window
    if cfg.attn_chunk is not None and not _is_global(cfg, layer_idx):
        m &= (q_pos[:, None] // cfg.attn_chunk) == (kv_pos[None, :]
                                                   // cfg.attn_chunk)
    return m


def _sdpa_dense(cfg, layer_idx, q, kk, vv, q_pos, kv_pos, kv_valid=None):
    """Materialized-scores GQA attention, with the reference's roundings.
    q: (B, Sq, H, hd); kk, vv: (B, Kv, Skv, hd), the cache's layout (the
    reference's is (B, Skv, Kv, hd)) -> (B, Sq, H, hd).

    The products run as ``bmm`` over the B * Kv heads of kk and vv as they
    lie (``kk.transpose`` is a view), so no copy of K or V is made."""
    B, Sq, H, hd = q.shape
    Kv, Skv = kk.shape[1], kk.shape[2]
    G = H // Kv
    # (B, Sq, Kv, G, hd) -> (B * Kv, G * Sq, hd): a view when Sq is 1
    qg = q.reshape(B, Sq, Kv, G, hd).permute(0, 2, 3, 1, 4).reshape(
        B * Kv, G * Sq, hd)
    k3 = kk.reshape(B * Kv, Skv, hd)
    v3 = vv.reshape(B * Kv, Skv, hd)
    s = torch.bmm(qg, k3.transpose(1, 2)).to(torch.float32)
    s.mul_(1.0 / (hd ** 0.5))
    m = _mask(cfg, layer_idx, q_pos, kv_pos)
    if kv_valid is not None:
        m = m & kv_valid[None, :]
    # row (g, s) of s takes the mask's row s
    s.masked_fill_(~(m if Sq == 1 else m.repeat(G, 1)), -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.bmm(p, v3)                                  # (B*Kv, G*Sq, hd)
    return o.reshape(B, Kv, G, Sq, hd).permute(0, 3, 1, 2, 4).reshape(
        B, Sq, H, hd)


def _write_kv(ck, cv, kx, vx, write_idx):
    """Write the S new positions' K and V (B, S, Kv, hd) into a layer's
    cache (B, Kv, Skv, hd) in place, at slots ``write_idx + [0, S)``: the
    reference's ``dynamic_update_slice``, whose start is clamped so that
    the S slots fit.  ``write_idx`` is a 0-dim device tensor, so nothing
    reads it on the host."""
    S, Skv = kx.shape[1], ck.shape[2]
    if S == 1:
        idx = write_idx.reshape(1)
    else:
        idx = write_idx.clamp(0, Skv - S) + torch.arange(
            S, device=ck.device, dtype=write_idx.dtype)
    ck.index_copy_(2, idx, kx.transpose(1, 2))
    cv.index_copy_(2, idx, vx.transpose(1, 2))


def _local_terms(cfg, layer_idx):
    """The layer's ``window`` and ``chunk`` for ``ops.flash_attention``."""
    chunk = None if _is_global(cfg, layer_idx) else cfg.attn_chunk
    return {"window": cfg.attn_window, "chunk": chunk}


def _attn_block(cfg, lp, layer_idx, x, q_pos, cache=None):
    """Self-attention sublayer; returns ``(x + o @ wo, (k, v))``.  With
    ``cache=(ck, cv, kv_pos, kv_valid, write_idx)`` (ck, cv a layer's
    (B, Kv, Skv, hd) cache), writes the new K and V into it in place and
    attends over it (decode, ``_sdpa_dense``); otherwise self-attends over
    x through the flash kernel, under the layer's mask (``_mask``)."""
    B, S, _ = x.shape
    q, kx, vx = _qkv(cfg, lp, x, q_pos)
    if cache is not None:
        ck, cv, kv_pos, kv_valid, write_idx = cache
        _write_kv(ck, cv, kx, vx, write_idx)
        o = _sdpa_dense(cfg, layer_idx, q, ck, cv, q_pos, kv_pos, kv_valid)
        new_cache = (ck, cv)
    else:
        o = ops.flash_attention(q, kx, vx, causal=True,
                                **_local_terms(cfg, layer_idx))
        new_cache = (kx, vx)
    return x + o.reshape(B, S, -1) @ lp["wo"], new_cache


def _ffn_block(cfg, lp, x, with_aux=True):
    """The FFN sublayer -> (x + y, aux): y = (silu(h @ w_gate) * (h @ w_up))
    @ w_down and aux None (dense), or ``moe.moe_ffn``'s y and float32
    aux (None without ``with_aux``)."""
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if cfg.n_experts:
        y, aux = moe.moe_ffn(h, lp, cfg, with_aux)
        return x + y, aux
    g = torch.nn.functional.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return x + g @ lp["w_down"], None


def _layer(cfg, lp, layer_idx, x, q_pos, cache=None):
    """-> (x, new_cache, aux); decode (a cache) computes no aux."""
    x, new_cache = _attn_block(cfg, lp, layer_idx, x, q_pos, cache)
    x, aux = _ffn_block(cfg, lp, x, with_aux=cache is None)
    return x, new_cache, aux


# ---------------------------------------------------------------- forward
def _layer_out(cfg, lp, layer_idx, x, q_pos):
    x, _, aux = _layer(cfg, lp, layer_idx, x, q_pos)
    return x, aux


def trunk(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> (final-normed hidden (B, S, D), aux_loss).  The
    tokens go to the parameters' device; aux_loss (0-dim float32) is the
    sum of the MoE layers' load-balance losses, 0 for dense FFNs.  With
    grad enabled each layer is recomputed in the backward (the
    reference's ``nothing_saveable`` checkpoint of the scanned body)."""
    _check_ported(cfg)
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    B, S = tokens.shape
    x = embed_lookup(embed, tokens)
    q_pos = torch.arange(S, dtype=torch.int32, device=embed.device)
    auxs = []
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        if torch.is_grad_enabled():
            x, aux = torch.utils.checkpoint.checkpoint(
                _layer_out, cfg, lp, i, x, q_pos, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, _, aux = _layer(cfg, lp, i, x, q_pos)
        if aux is not None:
            auxs.append(aux)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not auxs:
        return x, torch.zeros((), dtype=torch.float32, device=embed.device)
    return x, torch.stack(auxs).sum()


def _head(params, cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def forward(params, tokens, cfg: TransformerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux_loss scalar)."""
    x, aux = trunk(params, tokens, cfg)
    return x @ _head(params, cfg), aux


def _chunk_ce(xc, head, lc):
    return torch.sum(softmax_cross_entropy(xc @ head, lc))


def loss_fn(params, batch, cfg: TransformerConfig) -> torch.Tensor:
    """batch: {'tokens': (B, S), 'labels': (B, S)} integer tensors or
    arrays -> the mean token cross-entropy, a 0-dim float32 tensor.

    The head and the cross-entropy run in ``n_chunks`` chunks of the
    sequence, the reference's count (``max(1, min(T // ce_chunk_tokens,
    S, 64))``, lowered until it divides S), each under a checkpoint, so
    one chunk's (tokens, V) logits are live at a time; the chunks' sums
    are added in order and divided by T = B S."""
    x, aux = trunk(params, batch["tokens"], cfg)
    head = _head(params, cfg)
    labels = torch.as_tensor(batch["labels"], device=x.device)
    B, S, D = x.shape
    T = B * S
    n_chunks = max(1, min(T // max(cfg.ce_chunk_tokens, 1), S, 64))
    while S % n_chunks:
        n_chunks -= 1
    c = S // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        xc, lc = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            part = torch.utils.checkpoint.checkpoint(
                _chunk_ce, xc, head, lc, use_reentrant=False,
                preserve_rng_state=False)
        else:
            part = _chunk_ce(xc, head, lc)
        total = total + part
    return total / T + cfg.router_aux_coef * aux


def prefill(params, tokens, cfg: TransformerConfig) -> torch.Tensor:
    """Inference prefill: tokens (B, S) -> next-token logits (B, V).

    The reference computes every position's logits and keeps the last; the
    head is the same function at each position, so this applies it to the
    last position only (the full (B, S, V) logits of 4 x 4096 tokens would
    be 5 GB of bfloat16)."""
    x, _ = trunk(params, tokens, cfg)
    return x[:, -1] @ _head(params, cfg)


# ----------------------------------------------------------------- decode
def cache_len(cfg: TransformerConfig, seq_len: int) -> int:
    """Physical KV length: SWA models keep only a window-size ring buffer."""
    if cfg.attn_window is not None:
        return min(seq_len, cfg.attn_window)
    return seq_len


def init_cache(cfg: TransformerConfig, batch: int, seq_len: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    """An empty KV cache for ``batch`` slots on ``device`` (CUDA unless the
    caller asks for the CPU): ``k`` and ``v`` (L, B, Kv, Skv, hd) zeros in
    the model dtype, ``pos`` the absolute position of each physical slot
    (-1: empty) and ``t`` the next absolute position, int32 on the device.
    All slots share ``pos`` and ``t``, as in the reference."""
    _check_ported(cfg)
    device = resolve_device(device)
    Skv = cache_len(cfg, seq_len)
    shp = (cfg.n_layers, batch, cfg.n_kv_heads, Skv, cfg.hd)
    return {
        "k": torch.zeros(shp, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shp, dtype=cfg.dtype, device=device),
        "pos": torch.full((Skv,), -1, dtype=torch.int32, device=device),
        "t": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_step(params, cache, tokens, cfg: TransformerConfig):
    """One serving step: tokens (B,) -> (logits (B, V), cache).

    The new token's K and V go to slot ``t % Skv`` (a ring buffer: for SWA
    models old entries are evicted; a full-attention cache covers the whole
    context, so nothing is overwritten), ``pos[t % Skv] = t`` and ``t``
    advances.  The cache is updated in place and returned (the reference
    returns a new one and its server donates the old).  Nothing is read on
    the host: ``t`` and the write index stay on the device.  Tokens on the
    host go to the parameters' device without waiting (from pinned memory,
    the copy overlaps)."""
    _check_ported(cfg)
    embed = params["embed"]
    tokens = torch.as_tensor(tokens)
    if tokens.device != embed.device:
        tokens = tokens.to(embed.device, non_blocking=True)
    B = tokens.shape[0]
    ck_all, cv_all, pos, t = cache["k"], cache["v"], cache["pos"], cache["t"]
    Skv = ck_all.shape[3]
    write_idx = torch.remainder(t, Skv).to(torch.int64)
    q_pos = t.reshape(1)
    pos.index_copy_(0, write_idx.reshape(1), q_pos)
    kv_valid = pos >= 0

    x = embed.index_select(0, tokens.reshape(-1)).reshape(B, 1, -1)
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        x, _, _ = _layer(cfg, lp, i, x, q_pos,
                         cache=(ck_all[i], cv_all[i], pos, kv_valid,
                                write_idx))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ _head(params, cfg))[:, 0]
    t.add_(1)
    return logits, cache
