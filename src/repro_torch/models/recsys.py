"""The paper's CTR model (Fig. 2): multi-hot sparse input -> 64-d embedding
bags per field -> field self-attention -> MLP; and DLRM (MLPerf): 13 dense
features through a bottom MLP, 26 single-hot embeddings, the pairwise dot
interaction, a top MLP.

Counterpart of the CTR and DLRM parts of ``repro/models/recsys.py``.  The
dense parameters are a plain dict of tensors in the reference's layout
(``wq``/``wk``/``wv`` are (d, d), an MLP is a list of ``{"w", "b"}``).
Both models train and serve; on the card DLRM's interaction runs as a CUDA
kernel in each direction (``ops.dot_interaction``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from repro_torch.core.embedding_engine import EmbeddingEngine, TableSpec
from repro_torch.kernels import ops
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
