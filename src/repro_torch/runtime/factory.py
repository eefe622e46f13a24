"""Config-driven construction: ``build_trainer(arch, TrainerConfig)``.

Counterpart of ``repro/runtime/factory.py`` for the archs the port has
reached (the recsys archs ``baidu-ctr``, ``dlrm-mlperf``, ``din``,
``dien`` and ``two-tower-retrieval``, each training and serving; the
LMs ``qwen3-14b``, ``qwen2-7b``, ``granite-8b``, ``mixtral-8x7b`` and
``llama4-scout-17b-16e`` training, on a ``DenseTrainer``; the GNN
``gin-tu`` training, on a ``DenseTrainer`` too):

    tr = build_trainer("qwen3-14b", TrainerConfig(n_pod=2))
    tr = build_trainer("mixtral-8x7b", TrainerConfig(n_pod=2))
    tr = build_trainer("gin-tu", TrainerConfig(n_pod=2), model_cfg=...)
    tr = build_trainer("baidu-ctr", TrainerConfig(placement="gather"))
    tr = build_trainer("dlrm-mlperf", TrainerConfig(placement="gather"))
    tr = build_trainer("din", TrainerConfig(placement="gather"))
    tr = build_trainer("baidu-ctr", TrainerConfig(placement="cached",
                                                  cache_rows=262144))
    tr = build_trainer("baidu-ctr", TrainerConfig(store="disk",
                                                  spill_dir="/path/to/pages"))
    tr = build_trainer("baidu-ctr", TrainerConfig(prefetch=True))
    history, auc = fit_online(tr, ctr_batches(...), steps)   # training
    server = build_ctr_server(tr, max_batch=1024)            # serving

``TrainerConfig.prefetch`` turns on the double-buffered pull prefetch of a
recsys trainer (every arch, both placements, both stores; bit-identical
results; ``core.prefetch``); a ``DenseTrainer`` arch rejects it.

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
from repro_torch.runtime.trainer import (DenseTrainer, HybridTrainer,
                                         TrainerConfig, next_pow2)

# Bounds the deduplicated ids of one global batch at smoke/example scales;
# the default clamps to the table size.  At full width (batch 1024 x 100
# Zipf ids over 50 M rows) a batch holds ~34 k distinct ids, so such runs
# pass TrainerConfig.capacity = 65536 (PERF.md).
DEFAULT_CTR_CAPACITY = 1 << 14
TABLE_SCALE = 0.05   # std of the initial table rows (the reference's default)


def _default_capacity(max_rows: int) -> int:
    return next_pow2(min(DEFAULT_CTR_CAPACITY, max_rows))


def _build_engine(specs, cfg: TrainerConfig, device) -> EmbeddingEngine:
    """Placement-selected engine over ``specs`` (shared by the recsys
    archs); the kernels run per ``cfg.fused_kernels``
    (``ops.resolve_fused``).  The cached placement's device cache holds
    ``cfg.cache_rows`` rows, by default the capacity (one batch's working
    set); an explicit ``cache_rows`` below the capacity raises.
    ``cfg.store == "disk"`` puts the tables in a ``DiskStore`` under
    ``cfg.spill_dir`` (pages of ``cfg.page_rows`` rows, default 1024,
    behind a page cache of ``cfg.page_cache_pages`` pages, default
    unbounded) and stages the backend."""
    device = resolve_device(device)
    capacity = cfg.capacity or _default_capacity(
        max(s.rows for s in specs.values()))
    fused = ops.resolve_fused(cfg.fused_kernels, device)
    # ---- the cold tier (three levels when store="disk")
    if cfg.store == "host" and (cfg.page_rows is not None
                                or cfg.page_cache_pages is not None):
        # no silent config: page geometry without the disk tier is a
        # mis-specified experiment, not a default to ignore
        raise ValueError(
            "page_rows/page_cache_pages are disk-store knobs; set "
            "store='disk' (with spill_dir) to use them")
    if cfg.store == "disk" and cfg.placement == "routed":
        raise NotImplementedError(
            "store='disk' with placement='routed' is not implemented: the "
            "routed exchange addresses shard-resident rows, which the "
            "staged working-set dataflow does not provide; use 'gather' "
            "or 'cached'")
    kwargs = {}
    if cfg.store == "disk":
        kwargs["staged"] = True
        if cfg.placement == "cached":
            kwargs["capacity"] = capacity   # sizes the per-pull spill rows
    if cfg.placement == "cached":
        # an EXPLICIT undersized cache_rows is an error, not a silent clamp
        # (a cache-size experiment must run with the cache it asked for)
        if cfg.cache_rows and cfg.cache_rows < capacity:
            raise ValueError(
                f"cache_rows ({cfg.cache_rows}) must cover the working-set "
                f"capacity ({capacity}): one batch's pull must fit in the "
                f"device cache"
            )
        kwargs["cache_rows"] = cfg.cache_rows or capacity
    backend = make_backend(cfg.placement, fused=fused, device=device,
                           **kwargs)
    # the store last: a DiskStore starts its IO threads
    store = make_store(
        cfg.store, spill_dir=cfg.spill_dir,
        page_rows=cfg.page_rows if cfg.page_rows is not None else 1024,
        page_cache_pages=cfg.page_cache_pages)
    return EmbeddingEngine(
        specs, capacity=capacity, optimizer=SparseAdagrad(cfg.sparse),
        backend=backend, store=store, device=device,
    )


def build_ctr_engine(model_cfg: R.CTRConfig, cfg: TrainerConfig,
                     device="cuda") -> EmbeddingEngine:
    """EmbeddingEngine for the paper's CTR model (``_build_engine``)."""
    return _build_engine(R.ctr_table_specs(model_cfg), cfg, device)


def build_dlrm_engine(model_cfg: R.DLRMConfig, cfg: TrainerConfig,
                      device="cuda") -> EmbeddingEngine:
    """DLRM: 26 per-feature tables sharing the (B, 26) ``sparse_ids``
    field (``_build_engine``)."""
    return _build_engine(R.dlrm_table_specs(model_cfg), cfg, device)


def build_din_engine(model_cfg: R.DINConfig, cfg: TrainerConfig,
                     device="cuda") -> EmbeddingEngine:
    """DIN/DIEN: one item table fed by history + target ids
    (``_build_engine``)."""
    return _build_engine(R.din_table_specs(model_cfg), cfg, device)


def build_two_tower_engine(model_cfg: R.TwoTowerConfig, cfg: TrainerConfig,
                           device="cuda") -> EmbeddingEngine:
    """Two-tower retrieval: one item table fed by user history + item ids
    (``_build_engine``)."""
    return _build_engine(R.two_tower_table_specs(model_cfg), cfg, device)


def _recsys_wiring(mcfg):
    """(init_dense, build_engine, embed_adapter, loss_adapter) for a recsys
    model config, dispatched on the config type (so a ``model_cfg``
    override and dien, a ``DINConfig`` with ``gru_dim > 0``, route
    right)."""
    wiring = {
        R.CTRConfig: (R.ctr_init_dense, build_ctr_engine,
                      R.ctr_embed_from_workings, R.ctr_hybrid_loss),
        R.DLRMConfig: (R.dlrm_init_dense, build_dlrm_engine,
                       R.dlrm_embed_from_workings, R.dlrm_hybrid_loss),
        R.DINConfig: (R.din_init_dense, build_din_engine,
                      R.din_embed_from_workings, R.din_hybrid_loss),
        R.TwoTowerConfig: (R.two_tower_init_dense, build_two_tower_engine,
                           R.two_tower_embed_from_workings,
                           R.two_tower_hybrid_loss),
    }
    for cls, w in wiring.items():
        if isinstance(mcfg, cls):
            return w
    raise TypeError(
        f"build_trainer: unknown recsys model config {type(mcfg).__name__} "
        f"(expected one of {sorted(c.__name__ for c in wiring)})")


def build_trainer(arch: str, cfg: TrainerConfig, *, smoke: bool = True,
                  seed: int = 0, model_cfg: Any = None,
                  table_scale: float = TABLE_SCALE,
                  device="cuda"):
    """Construct the trainer for ``arch`` from the config registry: for an
    LM a ``DenseTrainer`` over ``transformer.loss_fn``, for a GNN one over
    ``gin.loss_fn``; for a recsys arch a
    ``HybridTrainer`` (the dense tower under ``cfg.kstep``, the tables
    drawn with std ``table_scale``)."""
    device = resolve_device(device)
    spec = configs.get(arch)
    mcfg = model_cfg if model_cfg is not None else (
        spec.smoke_cfg if smoke else spec.model_cfg)
    if spec.family == "lm":
        from repro_torch.models import transformer as T

        params = T.init_params(torch.Generator(device).manual_seed(seed),
                               mcfg, device=device)
        return DenseTrainer(lambda p, b: T.loss_fn(p, b, mcfg), params, cfg,
                            device=device)
    if spec.family == "gnn":
        from repro_torch.models import gin as G

        params = G.init_params(torch.Generator(device).manual_seed(seed),
                               mcfg, device=device)
        return DenseTrainer(lambda p, b: G.loss_fn(p, b, mcfg), params, cfg,
                            device=device)
    init_dense, build_engine, embed_of, loss_of = _recsys_wiring(mcfg)
    generator = torch.Generator(device).manual_seed(seed)
    dense = init_dense(generator, mcfg, device=device)
    engine = build_engine(mcfg, cfg, device=device)
    tables = engine.init(generator, scale=table_scale)
    fused = ops.resolve_fused(cfg.fused_kernels, device)
    return HybridTrainer(
        dense, engine, embed_of(mcfg, fused=fused), loss_of(mcfg), cfg,
        tables=tables, device=device,
    )


def build_ctr_server(trainer, max_batch: int = 64):
    """Serving tier over a live ``HybridTrainer`` (``runtime.serve_ctr``)."""
    from repro_torch.runtime.serve_ctr import CTRServer

    if not isinstance(trainer, HybridTrainer):
        raise TypeError(
            "build_ctr_server: CTR serving reads a HybridTrainer's live "
            f"embedding state, got {type(trainer).__name__}")
    return CTRServer(trainer, max_batch=max_batch)
