"""Evaluation metrics (AUC is the paper's quality measure).

A copy of ``repro/runtime/metrics.py``: ``auc`` and ``StreamingAUC``.
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
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks for ties
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
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
