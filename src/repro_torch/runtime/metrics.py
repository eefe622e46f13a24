"""Evaluation metrics (AUC is the paper's quality measure).

``auc`` and ``StreamingAUC`` of ``repro/runtime/metrics.py``, the same
values; ``auc`` gives tied scores their average rank by whole arrays, not
by a Python loop over the scores (a full-width online window holds
millions of them).
"""

from __future__ import annotations

import numpy as np


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact AUC via the rank statistic (ties get average rank)."""
    labels = np.asarray(labels).astype(np.float64).reshape(-1)
    scores = np.asarray(scores).astype(np.float64).reshape(-1)
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    # a run of equal scores at sorted positions i..j takes the average rank
    # (i + j + 2) / 2 (1-based); a lone score at i takes i + 1
    first = np.ones(len(scores), dtype=bool)
    first[1:] = sorted_scores[1:] != sorted_scores[:-1]
    starts = np.flatnonzero(first)
    ends = np.append(starts[1:], len(scores)) - 1
    ranks = np.empty_like(scores)
    ranks[order] = ((starts + ends + 2) / 2.0)[np.cumsum(first) - 1]
    return float((ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))



class StreamingAUC:
    """Online-learning evaluation (paper §5 Data: predict-then-train)."""

    def __init__(self, window: int = 0):
        self.labels: list = []
        self.scores: list = []
        self.window = window

    def update(self, labels, scores):
        self.labels.append(np.asarray(labels).reshape(-1))
        self.scores.append(np.asarray(scores).reshape(-1))
        if self.window and len(self.labels) > self.window:
            self.labels.pop(0)
            self.scores.pop(0)

    def value(self) -> float:
        if not self.labels:
            return 0.5
        return auc(np.concatenate(self.labels), np.concatenate(self.scores))
