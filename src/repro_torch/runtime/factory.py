"""Config-driven construction: ``build_trainer(arch, TrainerConfig)``.

Counterpart of ``repro/runtime/factory.py`` for the archs the port has
reached (``baidu-ctr``):

    tr = build_trainer("baidu-ctr", TrainerConfig(placement="gather"))
    history, auc = fit_online(tr, ctr_batches(...), steps)   # training
    server = build_ctr_server(tr, max_batch=1024)            # serving

Everything lands on ``device`` (CUDA unless the caller passes "cpu"; without
CUDA it raises).  Weights and tables are drawn from a ``torch.Generator``
seeded with ``seed``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import configs, resolve_device
from repro_torch.core.embedding_backend import make_backend
from repro_torch.core.embedding_engine import EmbeddingEngine
from repro_torch.core.row_store import make_store
from repro_torch.core.sparse_optim import SparseAdagrad
from repro_torch.kernels import ops
from repro_torch.models import recsys as R
from repro_torch.runtime.trainer import HybridTrainer, TrainerConfig, next_pow2

# Bounds the deduplicated ids of one global batch at smoke/example scales;
# the default clamps to the table size.  At full width (batch 1024 x 100
# Zipf ids over 50 M rows) a batch holds ~34 k distinct ids, so such runs
# pass TrainerConfig.capacity = 65536 (PERF.md).
DEFAULT_CTR_CAPACITY = 1 << 14
TABLE_SCALE = 0.05   # std of the initial table rows (the reference's default)


def _default_capacity(max_rows: int) -> int:
    return next_pow2(min(DEFAULT_CTR_CAPACITY, max_rows))


def build_ctr_engine(model_cfg: R.CTRConfig, cfg: TrainerConfig,
                     device="cuda") -> EmbeddingEngine:
    """EmbeddingEngine for the paper's CTR model, placement-selected; the
    push runs its kernel per ``cfg.fused_kernels`` (``ops.resolve_fused``)."""
    device = resolve_device(device)
    specs = R.ctr_table_specs(model_cfg)
    capacity = cfg.capacity or _default_capacity(
        max(s.rows for s in specs.values()))
    fused = ops.resolve_fused(cfg.fused_kernels, device)
    return EmbeddingEngine(
        specs, capacity=capacity, optimizer=SparseAdagrad(cfg.sparse),
        backend=make_backend(cfg.placement, fused=fused),
        store=make_store(cfg.store), device=device,
    )


def build_trainer(arch: str, cfg: TrainerConfig, *, smoke: bool = True,
                  seed: int = 0, model_cfg: Any = None,
                  table_scale: float = TABLE_SCALE,
                  device="cuda") -> HybridTrainer:
    """Construct the trainer for ``arch`` from the config registry (the
    dense tower under ``cfg.kstep``, the tables drawn with std
    ``table_scale``)."""
    device = resolve_device(device)
    spec = configs.get(arch)
    mcfg = model_cfg if model_cfg is not None else (
        spec.smoke_cfg if smoke else spec.model_cfg)
    if not isinstance(mcfg, R.CTRConfig):
        raise NotImplementedError(
            f"build_trainer: {type(mcfg).__name__} is not ported yet "
            "(ROADMAP.md queue A)")
    generator = torch.Generator(device).manual_seed(seed)
    dense = R.ctr_init_dense(generator, mcfg, device=device)
    engine = build_ctr_engine(mcfg, cfg, device=device)
    tables = engine.init(generator, scale=table_scale)
    fused = ops.resolve_fused(cfg.fused_kernels, device)
    return HybridTrainer(
        dense, engine, R.ctr_embed_from_workings(mcfg, fused=fused),
        R.ctr_hybrid_loss(mcfg), cfg, tables=tables, device=device,
    )


def build_ctr_server(trainer, max_batch: int = 64):
    """Serving tier over a live ``HybridTrainer`` (``runtime.serve_ctr``)."""
    from repro_torch.runtime.serve_ctr import CTRServer

    if not isinstance(trainer, HybridTrainer):
        raise TypeError(
            "build_ctr_server: CTR serving reads a HybridTrainer's live "
            f"embedding state, got {type(trainer).__name__}")
    return CTRServer(trainer, max_batch=max_batch)
