"""Synthetic data streams with *learnable* signal.

The paper evaluates AUC on a production click stream; offline we need data
where AUC is meaningful, so every CTR generator draws labels from a hidden
teacher (hash-derived per-id weights + feature interactions) — a model that
trains is then measurably better than chance, and k-step-vs-baseline AUC
deltas (paper Fig. 9) are real quantities.

All generators are numpy-side (host pipeline territory) and deterministic in
their seed; different worker shards draw i.i.d. slices (paper §2.3: "the
streamed data for different nodes are in an i.i.d. distribution").

A copy of ``repro/data/synthetic.py``'s CTR, DLRM, DIN, two-tower and LM
streams and its graphs (``community_graph``, ``molecule_batches``): the
same seed gives byte-identical batches, so the port and the reference see
the same inputs.  ``recsys_batches`` picks the stream for a model config.
"""

from __future__ import annotations

import dataclasses
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


def dlrm_batches(
    seed: int, batch: int, rows, n_dense: int = 13, worker: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """DLRM stream: 13 dense features, 26 single-hot Zipf ids (one per
    table) and teacher labels."""
    rng = np.random.default_rng(seed + worker * 1_000_003)
    rows = list(rows)
    while True:
        dense = rng.standard_normal((batch, n_dense)).astype(np.float32)
        ids = np.stack(
            [_zipf_ids(rng, (batch,), r) for r in rows], axis=1
        )
        w = np.stack([_id_weights(ids[:, i], salt=31 * i + 7) for i in range(len(rows))], 1)
        score = w.mean(1) * 2.0 + 0.3 * dense[:, :4].sum(1) / 2.0 + 0.4 * w[:, 0] * w[:, 1]
        p = 1.0 / (1.0 + np.exp(-2.0 * score))
        label = (rng.random(batch) < p).astype(np.float32)
        yield {
            "dense": dense,
            "sparse_ids": ids.astype(np.int32),
            "label": label,
        }


def din_batches(
    seed: int, batch: int, vocab: int, seq_len: int = 100, worker: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Behavior-sequence stream: label = teacher affinity(target, history)."""
    rng = np.random.default_rng(seed + worker * 1_000_003)
    n_interests = 32
    while True:
        # each user has an interest cluster; history and positive targets
        # concentrate in it
        interest = rng.integers(0, n_interests, (batch,))
        base = interest * (vocab // n_interests)
        width = vocab // n_interests
        hist = (base[:, None] + _zipf_ids(rng, (batch, seq_len), width)) % vocab
        lens = rng.integers(seq_len // 4, seq_len + 1, (batch,))
        mask = (np.arange(seq_len)[None, :] < lens[:, None]).astype(np.float32)
        pos = rng.random(batch) < 0.5
        in_cluster = (base + _zipf_ids(rng, (batch,), width)) % vocab
        random_item = rng.integers(0, vocab, (batch,))
        target = np.where(pos, in_cluster, random_item)
        # teacher: affinity + noise
        aff = (_id_weights(target) * _id_weights(hist[:, 0]) * 0.3 + np.where(pos, 0.8, -0.8))
        p = 1.0 / (1.0 + np.exp(-2.0 * aff))
        label = (rng.random(batch) < p).astype(np.float32)
        yield {
            "hist_ids": hist.astype(np.int32),
            "hist_mask": mask,
            "target_id": target.astype(np.int32),
            "label": label,
        }


def two_tower_batches(
    seed: int, batch: int, vocab: int, hist_len: int = 50, worker: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Retrieval stream: a user's history in an interest cluster and a
    positive item from it (no label: the loss is in-batch softmax)."""
    rng = np.random.default_rng(seed + worker * 1_000_003)
    n_interests = 64
    while True:
        interest = rng.integers(0, n_interests, (batch,))
        base = interest * (vocab // n_interests)
        width = vocab // n_interests
        hist = (base[:, None] + _zipf_ids(rng, (batch, hist_len), width)) % vocab
        lens = rng.integers(hist_len // 4, hist_len + 1, (batch,))
        mask = (np.arange(hist_len)[None, :] < lens[:, None]).astype(np.float32)
        item = (base + _zipf_ids(rng, (batch,), width)) % vocab  # positive item
        yield {
            "user_ids": hist.astype(np.int32),
            "user_mask": mask,
            "item_id": item.astype(np.int32),
        }


def recsys_batches(
    model_cfg, batch: int, seed: int = 1, worker: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """The synthetic stream for a recsys model config, dispatched on its
    type (the launcher's counterpart of the factory's ``_recsys_wiring``)."""
    from repro_torch.models import recsys as R

    if isinstance(model_cfg, R.CTRConfig):
        return ctr_batches(seed=seed, batch=batch, rows=model_cfg.rows,
                           n_fields=model_cfg.n_fields,
                           nnz=model_cfg.nnz_per_instance, worker=worker)
    if isinstance(model_cfg, R.DLRMConfig):
        return dlrm_batches(seed=seed, batch=batch, rows=model_cfg.rows,
                            n_dense=model_cfg.n_dense, worker=worker)
    if isinstance(model_cfg, R.DINConfig):
        return din_batches(seed=seed, batch=batch, vocab=model_cfg.item_vocab,
                           seq_len=model_cfg.seq_len, worker=worker)
    if isinstance(model_cfg, R.TwoTowerConfig):
        return two_tower_batches(seed=seed, batch=batch,
                                 vocab=model_cfg.item_vocab,
                                 hist_len=model_cfg.user_hist_len,
                                 worker=worker)
    raise TypeError(f"no synthetic stream for {type(model_cfg).__name__}")


# -------------------------------------------------------------------- LM
def lm_batches(
    seed: int, batch: int, seq_len: int, vocab: int, worker: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Learnable token stream: affine-recurrence sequences (next token is a
    deterministic function of the previous) with random starts + noise."""
    rng = np.random.default_rng(seed + worker * 1_000_003)
    a, c = 31, 17
    while True:
        start = rng.integers(0, vocab, (batch, 1))
        toks = np.zeros((batch, seq_len + 1), np.int64)
        toks[:, 0] = start[:, 0]
        for t in range(seq_len):
            nxt = (toks[:, t] * a + c) % vocab
            noise = rng.random(batch) < 0.05
            toks[:, t + 1] = np.where(noise, rng.integers(0, vocab, batch), nxt)
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


# ------------------------------------------------------------------ graphs
@dataclasses.dataclass
class SyntheticGraph:
    x: np.ndarray          # (N, F)
    edge_src: np.ndarray   # (E,)
    edge_dst: np.ndarray   # (E,)
    labels: np.ndarray     # (N,)


def community_graph(
    seed: int, n_nodes: int, avg_degree: int, d_feat: int, n_classes: int,
) -> SyntheticGraph:
    """SBM-ish graph: intra-community edges dominate; features = noisy class
    prototypes, so a GNN can actually learn the labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, (n_nodes,))
    n_edges = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, (n_edges,))
    same = rng.random(n_edges) < 0.8
    # intra-community partner: another random node of the same class
    perm = np.argsort(labels, kind="stable")
    class_start = np.searchsorted(labels[perm], np.arange(n_classes))
    class_count = np.bincount(labels, minlength=n_classes)
    rnd = rng.integers(0, 1 << 31, (n_edges,))
    intra = perm[(class_start[labels[src]] + rnd % np.maximum(class_count[labels[src]], 1))]
    inter = rng.integers(0, n_nodes, (n_edges,))
    dst = np.where(same, intra, inter)
    protos = rng.standard_normal((n_classes, d_feat)).astype(np.float32)
    x = protos[labels] + 1.5 * rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    return SyntheticGraph(
        x=x, edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
        labels=labels.astype(np.int32),
    )


def molecule_batches(
    seed: int, batch: int, n_nodes: int, n_edges: int, d_feat: int,
    n_classes: int, worker: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batched disjoint small graphs with graph-level labels."""
    rng = np.random.default_rng(seed + worker * 1_000_003)
    while True:
        xs, srcs, dsts, gids, ys = [], [], [], [], []
        for g in range(batch):
            label = rng.integers(0, n_classes)
            x = rng.standard_normal((n_nodes, d_feat)).astype(np.float32) + label
            src = rng.integers(0, n_nodes, (n_edges,))
            dst = rng.integers(0, n_nodes, (n_edges,))
            xs.append(x)
            srcs.append(src + g * n_nodes)
            dsts.append(dst + g * n_nodes)
            gids.append(np.full((n_nodes,), g))
            ys.append(label)
        yield {
            "x": np.concatenate(xs, 0),
            "edge_src": np.concatenate(srcs, 0).astype(np.int32),
            "edge_dst": np.concatenate(dsts, 0).astype(np.int32),
            "graph_ids": np.concatenate(gids, 0).astype(np.int32),
            "labels": np.asarray(ys, np.int32),
        }
