"""Co-located CTR serving tier over the trainer's LIVE embedding state.

The paper's deployment serves ads models from the same parameter servers
that train them; here the analogue is a recsys inference server that reads
the ``HybridTrainer``'s live tables through the engine's READ-ONLY lookup
contract (``HybridTrainer.predict``) — a row trained at step t is servable
at the next prefetch-commit boundary, with zero effect on the training
trajectory or the training-interval stats.

Counterpart of ``repro/runtime/serve_ctr.py``, with the same FIFO and
padding rules: requests enter a FIFO deque, the server drains them in
dynamic batches of up to ``max_batch`` instances, and every batch handed to
``predict`` has exactly ``max_batch`` instances — a short tail batch is
padded by repeating a valid instance (the pad scores are computed and
discarded host-side), so occupancy never changes the shapes the card sees,
only which outputs are kept.

Thread-safety: the server is driven from the training loop's thread (the
co-located scenario interleaves ``drain()`` at commit boundaries); it is
not itself a network listener.  Under ``TrainerConfig.prefetch`` a drain
may come while the next batch's pull is in flight: ``predict`` then reads
the pending pull's state (on the DiskStore with the pending staged rows
laid over the pages), whose values are the committed ones, so the scores
are the synchronous run's.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class PredictRequest:
    """One inference instance: a feature dict WITHOUT the batch dim (and
    without a label — serving traffic is unlabeled; ``requests_from_batch``
    strips it)."""
    features: Dict[str, np.ndarray]
    score: Optional[float] = None       # filled by the server
    latency: Optional[float] = None     # submit -> scored, seconds
    _t_submit: float = 0.0


def requests_from_batch(batch: Dict[str, np.ndarray]) -> List[PredictRequest]:
    """Split a (B, ...) training-format batch into B single-instance
    requests, dropping ``label`` (a serving request has none)."""
    feats = {k: np.asarray(v) for k, v in batch.items() if k != "label"}
    n = next(iter(feats.values())).shape[0]
    return [PredictRequest({k: v[i] for k, v in feats.items()})
            for i in range(n)]


class CTRServer:
    """Dynamic-batching CTR scorer on a live ``HybridTrainer``.

    Every drained batch is exactly ``max_batch`` instances (tail batches pad
    by repeating instance 0 of the batch), so ``trainer.predict`` and the
    read-only lookup under it always see one shape.  Stats:
    ``served`` (requests scored, pads excluded), ``steps`` (predict calls),
    ``wall`` (seconds inside predict); per-request latencies accumulate in
    ``self.latencies`` for the percentile summary.
    """

    def __init__(self, trainer, max_batch: int = 64):
        self.trainer = trainer
        self.max_batch = int(max_batch)
        self.pending: Deque[PredictRequest] = collections.deque()
        self.stats = {"served": 0, "steps": 0, "wall": 0.0}
        self.latencies: List[float] = []

    def submit(self, req: PredictRequest) -> None:
        req._t_submit = time.perf_counter()
        self.pending.append(req)

    def submit_batch(self, batch: Dict[str, np.ndarray]) -> None:
        for req in requests_from_batch(batch):
            self.submit(req)

    def step(self) -> bool:
        """Score one dynamic batch off the queue head. False when idle."""
        if not self.pending:
            return False
        reqs = [self.pending.popleft()
                for _ in range(min(self.max_batch, len(self.pending)))]
        # pad the tail up to max_batch with copies of a real instance: the
        # card sees one static batch shape; pad scores are dropped
        feats = reqs[0].features
        batch = {
            k: np.stack([r.features[k] for r in reqs]
                        + [feats[k]] * (self.max_batch - len(reqs)))
            for k in feats
        }
        t0 = time.perf_counter()
        scores = self.trainer.predict(batch)
        t1 = time.perf_counter()
        self.stats["wall"] += t1 - t0
        self.stats["steps"] += 1
        self.stats["served"] += len(reqs)
        for i, req in enumerate(reqs):
            req.score = float(scores[i])
            req.latency = t1 - req._t_submit
            self.latencies.append(req.latency)
        return True

    def drain(self) -> int:
        """Serve until the queue is empty; returns requests scored."""
        before = self.stats["served"]
        while self.step():
            pass
        return self.stats["served"] - before

    def latency_percentiles(self) -> Dict[str, float]:
        """{p50, p99} over per-request submit->scored latency, seconds."""
        if not self.latencies:
            return {"p50": 0.0, "p99": 0.0}
        arr = np.asarray(self.latencies)
        return {"p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99))}

    def summary(self) -> Dict[str, float]:
        """Throughput + latency + serve-side lookup meters, one dict."""
        out: Dict[str, float] = {
            "served": float(self.stats["served"]),
            "steps": float(self.stats["steps"]),
            "wall_s": float(self.stats["wall"]),
            "qps": (self.stats["served"] / self.stats["wall"]
                    if self.stats["wall"] > 0 else 0.0),
        }
        out.update(self.latency_percentiles())
        out.update(self.trainer.serve_metrics())
        return out
