"""The recsys family of ``repro/models/recsys.py``, every model of it:

- the paper's CTR model (Fig. 2): multi-hot sparse input -> 64-d embedding
  bags per field -> field self-attention -> MLP;
- DLRM (MLPerf): 13 dense features through a bottom MLP, 26 single-hot
  embeddings, the pairwise dot interaction, a top MLP;
- DIN (target attention over a behaviour sequence) and DIEN (a GRU, then an
  attention-gated AUGRU over it), on one item table;
- two-tower retrieval: a mean bag of the user's history and the positive
  item through two L2-normalised towers, in-batch sampled softmax.

The dense parameters are a plain dict of tensors in the reference's layout
(``wq``/``wk``/``wv`` are (d, d), an MLP is a list of ``{"w", "b"}``).
Every model trains and serves; on the card its lookups run as the bag's
CUDA kernels (a take is a bag of one id) and DLRM's interaction as a CUDA
kernel in each direction (``ops.dot_interaction``).  The GRUs, the
attention MLPs and the towers are plain PyTorch, as the reference's are
jnp: it has no Pallas kernel for them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core.embedding_engine import EmbeddingEngine, TableSpec
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models.common import (
    bce_with_logits,
    he_init,
    mlp_apply,
    mlp_init,
)


@dataclasses.dataclass(frozen=True)
class CTRConfig:
    """The paper's web-search CTR model (Fig. 2)."""
    name: str = "baidu_ctr"
    rows: int = 4_000_000_000
    embed_dim: int = 64
    n_fields: int = 40
    nnz_per_instance: int = 100
    attn_heads: int = 4
    mlp: Sequence[int] = (512, 256, 1)
    dtype: Any = torch.float32


def ctr_table_specs(cfg: CTRConfig) -> Dict[str, TableSpec]:
    return {
        "sparse": TableSpec(
            "sparse", rows=cfg.rows, dim=cfg.embed_dim, id_field="ids"
        )
    }


def ctr_init_dense(generator: torch.Generator, cfg: CTRConfig,
                   device="cuda"):
    """The CTR tower's weights on ``device`` (CUDA unless the caller asks
    for the CPU; ``generator`` must live there)."""
    d = cfg.embed_dim
    return {
        "wq": he_init(generator, (d, d), cfg.dtype, device=device),
        "wk": he_init(generator, (d, d), cfg.dtype, device=device),
        "wv": he_init(generator, (d, d), cfg.dtype, device=device),
        "mlp": mlp_init(generator, [cfg.n_fields * d] + list(cfg.mlp),
                        cfg.dtype, device=device),
    }


def _segments(batch, cfg: CTRConfig) -> torch.Tensor:
    """Bag index of every id slot: instance * n_fields + field."""
    ids = batch["ids"]
    B = ids.shape[0]
    inst = torch.arange(B, dtype=torch.int32, device=ids.device)[:, None]
    return (inst * cfg.n_fields + batch["field_ids"].to(torch.int32)).reshape(-1)


def ctr_embed_from_workings(cfg: CTRConfig, fused: bool = True):
    """The HybridTrainer embed adapter: per-field bags over the pulled working
    set (``workings["sparse"]`` rows, ``invs["sparse"]`` the inverse map),
    pooled by ``TableSpec.combiner``; on the card the bag is the CUDA
    kernel."""
    combiner = ctr_table_specs(cfg)["sparse"].combiner

    def embed(workings, invs, batch):
        B = batch["ids"].shape[0]
        bags = EmbeddingEngine.bag_from_working(
            workings["sparse"], invs["sparse"], _segments(batch, cfg),
            num_bags=B * cfg.n_fields, weights=batch["mask"].reshape(-1),
            combiner=combiner, fused=fused,
        )
        return bags.reshape(B, cfg.n_fields, cfg.embed_dim)

    return embed


def ctr_hybrid_loss(cfg: CTRConfig):
    """The HybridTrainer loss adapter: BCE on the field-attention tower
    (``predict=True`` returns sigmoid scores)."""

    def loss(dense, emb, batch, predict=False):
        logits = ctr_forward_from_emb(dense, emb, batch, cfg)
        if predict:
            return torch.sigmoid(logits)
        return pointwise_loss(logits, batch["label"])

    return loss


def ctr_forward_from_emb(dense, emb, batch, cfg: CTRConfig) -> torch.Tensor:
    x = emb.to(cfg.dtype)                                           # (B,F,d)
    H = cfg.attn_heads
    d = cfg.embed_dim
    hd = d // H
    B, F, _ = x.shape
    q = (x @ dense["wq"]).reshape(B, F, H, hd)
    k = (x @ dense["wk"]).reshape(B, F, H, hd)
    v = (x @ dense["wv"]).reshape(B, F, H, hd)
    s = torch.einsum("bfhd,bghd->bhfg", q, k) / (hd ** 0.5)
    p = torch.softmax(s.to(torch.float32), dim=-1).to(cfg.dtype)
    o = torch.einsum("bhfg,bghd->bfhd", p, v).reshape(B, F, d)
    o = (x + o).reshape(B, F * d)
    return mlp_apply(dense["mlp"], o, act=torch.relu)[:, 0]


def pointwise_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(bce_with_logits(logits, labels))


# ======================================================================= DLRM
# Criteo-1TB per-feature cardinalities (MLPerf DLRM reference).
CRITEO_ROWS = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
]


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    bot_mlp: Sequence[int] = (13, 512, 256, 128)
    top_mlp: Sequence[int] = (1024, 1024, 512, 256, 1)
    rows: Sequence[int] = tuple(CRITEO_ROWS)
    dtype: Any = torch.float32

    @property
    def interact_dim(self) -> int:
        n = self.n_sparse + 1
        return n * (n - 1) // 2 + self.embed_dim


def dlrm_table_specs(cfg: DLRMConfig) -> Dict[str, TableSpec]:
    # 26 single-hot tables share one (B, 26) ``sparse_ids`` batch field:
    # table i reads column i (TableSpec.id_col).
    return {
        f"emb_{i:02d}": TableSpec(
            f"emb_{i:02d}", rows=cfg.rows[i], dim=cfg.embed_dim,
            id_field="sparse_ids", id_col=i,
        )
        for i in range(cfg.n_sparse)
    }


def dlrm_init_dense(generator: torch.Generator, cfg: DLRMConfig,
                    device="cuda"):
    """The bottom and top MLPs on ``device`` (CUDA unless the caller asks
    for the CPU; ``generator`` must live there)."""
    return {
        "bot": mlp_init(generator, list(cfg.bot_mlp), cfg.dtype,
                        device=device),
        "top": mlp_init(generator, [cfg.interact_dim] + list(cfg.top_mlp),
                        cfg.dtype, device=device),
    }


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) -> lower-triangle pairwise dots (B, F*(F-1)/2), in
    ``np.tril_indices(F, k=-1)`` order; on the card the CUDA kernels
    (forward and backward)."""
    return ops.dot_interaction(feats)


def dlrm_embed_batch(tables, batch, cfg: DLRMConfig) -> torch.Tensor:
    """sparse_ids (B, 26) single-hot -> (B, 26, D), from the full tables
    (the oracle the working-set path is held against)."""
    ids = batch["sparse_ids"].long()
    return torch.stack([tables[f"emb_{i:02d}"][ids[:, i]]
                        for i in range(cfg.n_sparse)], dim=1)


def dlrm_forward_from_emb(dense, emb, batch, cfg: DLRMConfig) -> torch.Tensor:
    x = mlp_apply(dense["bot"], batch["dense"].to(cfg.dtype), act=torch.relu)
    feats = torch.cat([x[:, None, :], emb.to(cfg.dtype)], dim=1)  # (B,27,D)
    inter = dot_interaction(feats)
    top_in = torch.cat([x, inter], dim=-1)
    return mlp_apply(dense["top"], top_in, act=torch.relu)[:, 0]


def dlrm_embed_from_workings(cfg: DLRMConfig, fused: bool = True):
    """The HybridTrainer embed adapter: the 26 single-hot takes from each
    table's working set (``invs["emb_XX"]`` has shape (B,), one row per
    instance; ids the capacity dropped read the zero drop row), so the
    gradients land on the pulled rows only.

    Each take is a bag of one id per instance (``seg = arange(B)``, no
    weights) through ``EmbeddingEngine.bag_from_working``: on the card the
    bag's kernels, whose backward adds a hot working row's entries in a
    fixed order in one walk.  (Autograd's index backward, the plain take's,
    runs a Zipf-hot id's thousands of entries one after another in a warp:
    most of a training step at batch 65536, PERF.md.)  The reference's
    ``jnp.take`` and its vjp are the same function."""

    def embed(workings, invs, batch):
        B = batch["sparse_ids"].shape[0]
        seg = torch.arange(B, dtype=torch.int32,
                           device=batch["sparse_ids"].device)
        return torch.stack(
            [EmbeddingEngine.bag_from_working(
                workings[f"emb_{i:02d}"], invs[f"emb_{i:02d}"], seg,
                num_bags=B, fused=fused)
             for i in range(cfg.n_sparse)], dim=1)           # (B, 26, D)

    return embed


def dlrm_hybrid_loss(cfg: DLRMConfig):
    """The HybridTrainer loss adapter: BCE over the dot-interaction tower
    (``predict=True`` returns sigmoid click scores)."""

    def loss(dense, emb, batch, predict=False):
        logits = dlrm_forward_from_emb(dense, emb, batch, cfg)
        if predict:
            return torch.sigmoid(logits)
        return pointwise_loss(logits, batch["label"])

    return loss


def _take_from_working(working, inv, fused):
    """``working[inv]`` as bags of one id (``seg = arange``, unweighted)
    through ``EmbeddingEngine.bag_from_working``: on the card the bag's
    kernels, whose backward adds a hot working row's entries in a fixed
    order (DLRM's takes, above)."""
    seg = torch.arange(inv.numel(), dtype=torch.int32, device=inv.device)
    return EmbeddingEngine.bag_from_working(
        working, inv.reshape(-1).contiguous(), seg, num_bags=inv.numel(),
        fused=fused)


# ==================================================================== DIN/DIEN
@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Sequence[int] = (80, 40)
    mlp: Sequence[int] = (200, 80)
    item_vocab: int = 2_000_000
    gru_dim: int = 0            # DIEN: 108; 0 disables the GRU/AUGRU stage
    dtype: Any = torch.float32


def din_table_specs(cfg: DINConfig) -> Dict[str, TableSpec]:
    # history + target ids feed ONE item table: the pull concatenates the
    # fields per instance into (B, seq_len + 1) before deduplicating.
    return {
        "items": TableSpec(
            "items", rows=cfg.item_vocab, dim=cfg.embed_dim,
            id_field=("hist_ids", "target_id"),
        )
    }


def din_init_dense(generator: torch.Generator, cfg: DINConfig,
                   device="cuda"):
    """The attention MLP, the output MLP and, for DIEN, the GRU, the AUGRU
    and the target's projection into the GRU's space, on ``device`` (CUDA
    unless the caller asks for the CPU; ``generator`` must live there)."""
    d = cfg.embed_dim
    w = cfg.gru_dim or d
    params = {
        "att": mlp_init(generator, [4 * w] + list(cfg.attn_mlp) + [1],
                        cfg.dtype, device=device),
        "mlp": mlp_init(generator, [w * 2 + 2 * d] + list(cfg.mlp) + [1],
                        cfg.dtype, device=device),
    }
    if cfg.gru_dim:
        h = cfg.gru_dim
        for name, d_in in (("gru", d), ("augru", h)):
            params[name] = {
                "wx": he_init(generator, (d_in, 3 * h), cfg.dtype,
                              device=device),
                "wh": he_init(generator, (h, 3 * h), cfg.dtype,
                              device=device),
                "b": torch.zeros((3 * h,), dtype=cfg.dtype, device=device),
            }
        params["tproj"] = he_init(generator, (d, h), cfg.dtype, device=device)
    return params


def _gru_scan(p, xs, h0, att: Optional[torch.Tensor] = None):
    """GRU over time; with ``att`` (T, B) the update gate is attention-scaled
    (AUGRU, Zhou et al. 2019).  xs: (T, B, d) -> (T, B, h), final h.

    The reference's ``lax.scan`` of its cell as a loop over T; the input
    projection of every step is one product before the loop (each row's
    sums are the same, only batched).  The steps take their slices by
    ``unbind``, whose backward stacks the T gradients once (indexing
    ``gx[t]`` would zero and add a whole (T, B, 3h) gradient a step); the
    reset and update gates are one sigmoid over their 2h columns, the
    same values as two."""
    H = p["wh"].shape[0]
    gxs = (xs @ p["wx"] + p["b"]).unbind(0)          # T x (B, 3h)
    atts = att.unbind(0) if att is not None else None
    h = h0
    hs = []
    for t, gx in enumerate(gxs):
        gh = h @ p["wh"]
        r, z = torch.sigmoid(gx[:, :2 * H] + gh[:, :2 * H]).chunk(2, dim=-1)
        # z, the update gate, weighs the NEW state
        n = torch.tanh(gx[:, 2 * H:] + r * gh[:, 2 * H:])
        if atts is not None:
            # AUGRU (DIEN eq. 5): u~_t = a_t * u_t; a = 0 leaves the hidden
            # state frozen
            z = atts[t][:, None] * z
        h = (1.0 - z) * h + z * n
        hs.append(h)
    return torch.stack(hs), h


def din_attention(dense, hist: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """hist (B,T,w), target (B,w) -> attention weights (B,T): the masked
    softmax over T of the attention MLP on ``[h, t, h - t, h * t]`` (DIEN
    calls it in the GRU's space, w = gru_dim)."""
    tt = target[:, None, :].expand_as(hist)
    feat = torch.cat([hist, tt, hist - tt, hist * tt], dim=-1)
    scores = mlp_apply(dense["att"], feat, act=torch.sigmoid)[..., 0]
    scores = torch.where(mask > 0, scores, torch.full_like(scores, -1e30))
    return torch.softmax(scores, dim=-1)


def din_embed_batch(tables, batch, cfg: DINConfig):
    """The history (B, T, d) and target (B, d) rows from the full table (the
    oracle the working-set path is held against)."""
    items = tables["items"]
    return {"hist": items[batch["hist_ids"].long()],
            "target": items[batch["target_id"].long()]}


def din_forward_from_emb(dense, emb, batch, cfg: DINConfig) -> torch.Tensor:
    hist = emb["hist"].to(cfg.dtype)
    target = emb["target"].to(cfg.dtype)
    mask = batch["hist_mask"].to(cfg.dtype)                       # (B,T)
    masked = hist * mask[..., None]
    if cfg.gru_dim:
        # DIEN: interest extraction GRU -> attention -> AUGRU evolution.  The
        # first GRU runs over the masked positions too (a zero input), so
        # its state moves there.
        h0 = torch.zeros((hist.shape[0], cfg.gru_dim), dtype=cfg.dtype,
                         device=hist.device)
        states, _ = _gru_scan(dense["gru"], masked.transpose(0, 1), h0)
        t_h = target @ dense["tproj"]                             # (B,h)
        att = din_attention(dense, states.transpose(0, 1), t_h, mask)
        _, final = _gru_scan(dense["augru"], states, h0, att=att.T)
        # the mean over T, not over the mask's count, as the reference has it
        rep = torch.cat([final, t_h, target,
                         target * 0 + torch.mean(masked, 1)], dim=-1)
    else:
        att = din_attention(dense, hist, target, mask)
        att_hist = torch.einsum("bt,btd->bd", att, hist)
        sum_pool = torch.sum(masked, dim=1)
        rep = torch.cat([att_hist, target, att_hist * target, sum_pool],
                        dim=-1)
    return mlp_apply(dense["mlp"], rep, act=torch.relu)[:, 0]


def din_embed_from_workings(cfg: DINConfig, fused: bool = True):
    """The HybridTrainer embed adapter for DIN/DIEN: history + target ids
    feed one item table (``din_table_specs`` joins the two fields per
    instance), so ``invs["items"]`` views as (B, seq_len + 1): the first
    ``seq_len`` columns are the history lookups, the last the target.

    The B x (seq_len + 1) takes are one call of the bag over bags of one id
    (``_take_from_working``): on the card kernels 1 and 1b, whose backward
    adds a hot item's thousands of entries in one ordered walk.  The
    reference's ``jnp.take`` and its vjp are the same function."""
    T = cfg.seq_len

    def embed(workings, invs, batch):
        B = batch["hist_ids"].shape[0]
        rows = _take_from_working(workings["items"], invs["items"], fused)
        rows = rows.view(B, T + 1, cfg.embed_dim)
        return {"hist": rows[:, :T], "target": rows[:, T]}

    return embed


def din_hybrid_loss(cfg: DINConfig):
    """The HybridTrainer loss adapter: BCE over the (AU)GRU/attention tower
    (``predict=True`` returns sigmoid click scores)."""

    def loss(dense, emb, batch, predict=False):
        logits = din_forward_from_emb(dense, emb, batch, cfg)
        if predict:
            return torch.sigmoid(logits)
        return pointwise_loss(logits, batch["label"])

    return loss


# ================================================================== two-tower
@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two_tower"
    embed_dim: int = 256
    tower_mlp: Sequence[int] = (1024, 512, 256)
    user_hist_len: int = 50
    item_vocab: int = 5_000_000
    temperature: float = 0.05
    # In-batch negatives are capped at this pool size: full BxB softmax at
    # production batch (65k) would materialize a 17 TB logits matrix.
    neg_pool: int = 4096
    dtype: Any = torch.float32


def two_tower_table_specs(cfg: TwoTowerConfig) -> Dict[str, TableSpec]:
    # user history + positive item share the item table, (B, hist_len + 1);
    # the user-history bag pools by the spec's combiner (mean over the
    # history window: the masked entries count in the divisor)
    return {
        "items": TableSpec(
            "items", rows=cfg.item_vocab, dim=cfg.embed_dim,
            combiner="mean", id_field=("user_ids", "item_id"),
        )
    }


def two_tower_init_dense(generator: torch.Generator, cfg: TwoTowerConfig,
                         device="cuda"):
    """The user and item towers on ``device`` (CUDA unless the caller asks
    for the CPU; ``generator`` must live there)."""
    sizes = [cfg.embed_dim] + list(cfg.tower_mlp)
    return {"user": mlp_init(generator, sizes, cfg.dtype, device=device),
            "item": mlp_init(generator, sizes, cfg.dtype, device=device)}


def _history_segments(B: int, H: int, device) -> torch.Tensor:
    return torch.arange(B, dtype=torch.int32,
                        device=device).repeat_interleave(H)


def two_tower_embed_batch(tables, batch, cfg: TwoTowerConfig):
    """The user's mean bag and the positive item's row from the full table
    (the oracle the working-set path is held against; the bag's plain
    version)."""
    ids = batch["user_ids"]
    B, H = ids.shape
    spec = two_tower_table_specs(cfg)["items"]
    user = ref.embedding_bag_combiner_ref(
        tables["items"], ids.reshape(-1).to(torch.int32),
        _history_segments(B, H, ids.device),
        batch["user_mask"].reshape(-1).to(tables["items"].dtype), B,
        spec.combiner)
    return {"user": user, "item": tables["items"][batch["item_id"].long()]}


def _tower(params, x, dtype):
    y = mlp_apply(params, x.to(dtype), act=torch.relu)
    # sqrt(max(|y|^2, eps^2)) == max(|y|, eps), but with a well-defined
    # gradient at y == 0: a plain norm's 0/0 gradient would NaN-poison the
    # push whenever a capacity-dropped id reads the all-zero drop row.
    sq = torch.sum(torch.square(y), dim=-1, keepdim=True)
    return y / torch.sqrt(torch.clamp_min(sq, 1e-12))


def two_tower_forward_from_emb(dense, emb, batch, cfg: TwoTowerConfig):
    u = _tower(dense["user"], emb["user"], cfg.dtype)   # (B, D)
    v = _tower(dense["item"], emb["item"], cfg.dtype)   # (B, D)
    return u, v


def two_tower_loss(dense, emb, batch, cfg: TwoTowerConfig) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction (Yi et al., RecSys'19).

    Negatives come from a pool of the first ``neg_pool`` in-batch items;
    each row's own positive is scored explicitly and its duplicate in the
    pool is masked, so the loss is exact sampled softmax for any batch size
    without a (B, B) logits matrix.
    """
    u, v = two_tower_forward_from_emb(dense, emb, batch, cfg)
    B = u.shape[0]
    M = min(cfg.neg_pool, B)
    pos = torch.sum(u * v, dim=-1) / cfg.temperature         # (B,)
    negs = (u @ v[:M].T) / cfg.temperature                   # (B, M)
    logq = batch.get("sample_logq")
    if logq is not None:
        negs = negs - logq[:M][None, :]
    # mask each row's own positive inside the pool (rows < M)
    dup = (torch.arange(B, device=u.device)[:, None]
           == torch.arange(M, device=u.device)[None, :])
    negs = torch.where(dup, torch.full((), -1e30, device=u.device),
                       negs.to(torch.float32))
    pos = pos.to(torch.float32)
    logz = torch.logsumexp(torch.cat([pos[:, None], negs], dim=1), dim=-1)
    return torch.mean(logz - pos)


def two_tower_score_candidates(dense, tables, user_emb_pooled, cand_ids,
                               cfg: TwoTowerConfig) -> torch.Tensor:
    """Retrieval scoring: one (or few) users against n_candidates items
    ((B, C) scores, each in [-1, 1])."""
    u = _tower(dense["user"], user_emb_pooled, cfg.dtype)            # (B, D)
    cand = tables["items"].index_select(0, cand_ids.long())          # (C, D)
    v = _tower(dense["item"], cand, cfg.dtype)
    return u @ v.T


def two_tower_embed_from_workings(cfg: TwoTowerConfig, fused: bool = True):
    """The HybridTrainer embed adapter: the user-history mean bag and the
    positive item, both from the pulled item working set (``invs["items"]``
    views as (B, hist_len + 1); see ``two_tower_table_specs``).  On the card
    the history bag is kernel 1 weighted by ``user_mask`` (the mean's
    division outside it) and the item a bag of one id; their backwards
    kernel 1b."""
    H = cfg.user_hist_len
    combiner = two_tower_table_specs(cfg)["items"].combiner

    def embed(workings, invs, batch):
        B = batch["user_ids"].shape[0]
        inv = invs["items"].reshape(B, H + 1)
        user = EmbeddingEngine.bag_from_working(
            workings["items"], inv[:, :H].reshape(-1),
            _history_segments(B, H, inv.device), num_bags=B,
            weights=batch["user_mask"].reshape(-1), combiner=combiner,
            fused=fused)
        item = _take_from_working(workings["items"], inv[:, H], fused)
        return {"user": user, "item": item}

    return embed


def two_tower_hybrid_loss(cfg: TwoTowerConfig):
    """The HybridTrainer loss adapter: in-batch sampled softmax with logQ
    correction; ``predict=True`` returns each instance's positive-item
    retrieval score u·v (the towers are L2-normalised, so scores lie in
    [-1, 1])."""

    def loss(dense, emb, batch, predict=False):
        if predict:
            u, v = two_tower_forward_from_emb(dense, emb, batch, cfg)
            return torch.sum(u * v, dim=-1)
        return two_tower_loss(dense, emb, batch, cfg)

    return loss
