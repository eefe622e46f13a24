"""The paper's CTR model (Fig. 2): multi-hot sparse input -> 64-d embedding
bags per field -> field self-attention -> MLP.

Counterpart of the CTR part of ``repro/models/recsys.py``.  The dense
parameters are a plain dict of tensors in the reference's layout
(``wq``/``wk``/``wv`` are (d, d), the MLP is a list of ``{"w", "b"}``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from repro_torch.core.embedding_engine import EmbeddingEngine, TableSpec
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
