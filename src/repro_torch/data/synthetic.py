"""Synthetic data streams with *learnable* signal.

The paper evaluates AUC on a production click stream; offline we need data
where AUC is meaningful, so every CTR generator draws labels from a hidden
teacher (hash-derived per-id weights + feature interactions) — a model that
trains is then measurably better than chance, and k-step-vs-baseline AUC
deltas (paper Fig. 9) are real quantities.

All generators are numpy-side (host pipeline territory) and deterministic in
their seed; different worker shards draw i.i.d. slices (paper §2.3: "the
streamed data for different nodes are in an i.i.d. distribution").

A copy of ``repro/data/synthetic.py``'s CTR stream: the same seed gives
byte-identical batches, so the port and the reference see the same inputs.
``recsys_batches`` picks the stream for a model config; the other recsys
archs' streams come with their slice (ROADMAP.md queue A9).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _id_weights(ids: np.ndarray, salt: int = 0x9E3779B9) -> np.ndarray:
    """Deterministic pseudo-random weight per id in [-1, 1] (splitmix-style)."""
    x = (ids.astype(np.uint64) + np.uint64(salt)) * np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return (x.astype(np.float64) / 2**64) * 2.0 - 1.0


def _zipf_ids(rng: np.random.Generator, shape, vocab: int, a: float = 1.1) -> np.ndarray:
    """Zipf-ish id draw truncated to vocab (hot-head like real CTR traffic)."""
    u = rng.random(shape)
    # inverse-CDF of a bounded pareto on [1, vocab]
    ids = (vocab ** (1 - a) * (1 - u) + u) ** (1 / (1 - a))
    return np.minimum(ids.astype(np.int64), vocab - 1)


# ------------------------------------------------------------------- CTR
def ctr_batches(
    seed: int, batch: int, rows: int, n_fields: int = 40, nnz: int = 100,
    worker: int = 0, zipf_a: float = 1.1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Paper CTR model stream: multi-hot ids + field ids + teacher labels.

    ``zipf_a`` sets the id skew (lower = flatter; the cache-tier hit-rate
    experiments use 1.05, the paper-motivated hot-head regime)."""
    rng = np.random.default_rng(seed + worker * 1_000_003)
    while True:
        ids = _zipf_ids(rng, (batch, nnz), rows, a=zipf_a)
        field_ids = rng.integers(0, n_fields, (batch, nnz)).astype(np.int32)
        mask = (rng.random((batch, nnz)) < 0.9).astype(np.float32)
        score = (_id_weights(ids) * mask).sum(1) / np.sqrt(nnz)
        pair = (_id_weights(ids, salt=17) * mask)
        score = score + 0.5 * (pair.sum(1) ** 2 - (pair ** 2).sum(1)) / nnz
        p = 1.0 / (1.0 + np.exp(-3.0 * score))
        label = (rng.random(batch) < p).astype(np.float32)
        yield {
            "ids": ids.astype(np.int32),
            "field_ids": field_ids,
            "mask": mask,
            "label": label,
        }


def recsys_batches(
    model_cfg, batch: int, seed: int = 1, worker: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """The synthetic stream for a recsys model config (``CTRConfig``: the
    CTR stream; the other configs are not ported yet)."""
    from repro_torch.models import recsys as R

    if isinstance(model_cfg, R.CTRConfig):
        return ctr_batches(seed=seed, batch=batch, rows=model_cfg.rows,
                           n_fields=model_cfg.n_fields,
                           nnz=model_cfg.nnz_per_instance, worker=worker)
    raise NotImplementedError(
        f"recsys_batches: {type(model_cfg).__name__} is not ported yet "
        "(ROADMAP.md queue A9, the other recsys archs)")
