"""The hybrid trainer (dense tower + sparse tables): its serving side.

Counterpart of ``repro/runtime/trainer.py``'s ``HybridTrainer``.  This
slice ports ``predict``: the engine's READ-ONLY lookup of the batch's rows,
the per-field bags over the working set (the CUDA kernel on the card), and
the dense tower of pod 0, with the serving meters (``serve_metrics``).  The
dense parameters keep the reference's leading pod dimension, so a state
exported from the reference loads unchanged (``repro_torch.interop``).

Training (``train_step``: pull, fwd/bwd, k-step Adam, push) is slice 2 of
the port (ROADMAP.md queue A) and raises until then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree_map
from repro_torch.core.embedding_engine import EmbeddingEngine
from repro_torch.core.sparse_optim import SparseAdagradConfig, SparseAdagradState

Tree = Any


@dataclasses.dataclass
class TrainerConfig:
    """The ``repro`` TrainerConfig fields the serving slice reads."""
    n_pod: int = 1
    sparse: SparseAdagradConfig = dataclasses.field(
        default_factory=SparseAdagradConfig)
    placement: str = "gather"       # sparse backend ("gather" is ported)
    capacity: Optional[int] = None  # working-set bound (None: arch default)
    fused_kernels: Optional[bool] = None  # None = auto: the CUDA kernels on
                                          # the card, the plain versions on
                                          # the CPU (ops.resolve_fused)
    store: str = "host"             # cold tier ("host" is ported)


def next_pow2(n) -> int:
    """Smallest power of two >= n."""
    cap = 1
    while cap < n:
        cap <<= 1
    return cap


def pod_replicate(tree: Tree, n_pod: int) -> Tree:
    """Stack identical replicas along a new leading pod dimension."""
    return tree_map(
        lambda x: x[None].expand((n_pod,) + tuple(x.shape)).clone(), tree)


def pod_slice(tree: Tree, i: int = 0) -> Tree:
    """One pod's replica (a view, no copy)."""
    return tree_map(lambda x: x[i], tree)


class HybridTrainer:
    """Dense tower + sparse tables behind an ``EmbeddingEngine``.

    Parameters
    ----------
    dense_params: the dense tower's parameter tree (un-podded).
    engine: owns TableSpecs, capacity, the sparse optimizer, the backend.
    embed_fn(workings, invs, batch): model inputs from the pulled rows.
    loss_fn(dense, emb, batch, predict=False): the dense side
        (``predict=True`` returns scores).
    tables: the initialised tables in the backend's layout (e.g.
        ``engine.init(generator)``).
    state: a ``repro_torch.interop.ReferenceState`` (podded dense, tables,
        accumulator), in place of ``dense_params`` and ``tables``.
    device: where everything lives; CUDA unless the caller asks for "cpu".
    """

    def __init__(self, dense_params: Optional[Tree], engine: EmbeddingEngine,
                 embed_fn: Callable, loss_fn: Callable, cfg: TrainerConfig,
                 tables: Optional[Dict[str, torch.Tensor]] = None, *,
                 state=None, device="cuda"):
        self.cfg = cfg
        self.n_pod = cfg.n_pod
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(f"engine lives on {engine.device}, trainer on "
                             f"{self.device}")
        self.engine = engine
        accum = None
        if state is not None:
            if dense_params is not None or tables is not None:
                raise ValueError("pass either state or dense_params/tables")
            self.dense = state.dense
            tables, accum = state.tables, state.accum
            for leaf in _leaves(self.dense):
                if leaf.shape[0] != self.n_pod:
                    raise ValueError(
                        f"state.dense has {leaf.shape[0]} pod replicas, "
                        f"cfg.n_pod is {self.n_pod}")
        elif tables is None:
            raise ValueError("pass tables (e.g. engine.init(generator)) or "
                             "state")
        else:
            self.dense = pod_replicate(dense_params, self.n_pod)
        for name, spec in engine.specs.items():
            if tuple(tables[name].shape) != (spec.rows, spec.dim):
                raise ValueError(
                    f"table {name!r} is {tuple(tables[name].shape)}, spec "
                    f"says {(spec.rows, spec.dim)}")
        self.tables = tables
        self.sparse_state = (engine.init_state(tables) if accum is None
                             else SparseAdagradState(accum))
        self.backend_state = engine.init_backend_state(tables)
        self._embed = embed_fn
        self._loss = loss_fn
        # serving-side meters, accumulated host-side per predict
        self._serve_counters: Dict[str, float] = {}

    def train_step(self, batch):
        raise NotImplementedError(
            "HybridTrainer.train_step is not ported yet: training on the "
            "gather placement is slice 2 of the port (ROADMAP.md queue A)")

    def _stage(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def predict(self, batch) -> np.ndarray:
        """Scores of a batch with pod 0's dense replica, on the engine's
        READ-ONLY lookup: the rows a pull would serve, with nothing
        written."""
        with torch.inference_mode():
            scores, aux = self._predict_traced(
                self.dense, self.tables, self.sparse_state.accum,
                self.backend_state, self._stage(batch))
            return self._finish_predict(scores, aux)

    def _predict_traced(self, dense, tables, accum, bstate, batch):
        dense0 = pod_slice(dense, 0)
        wss, aux = self.engine.lookup_batch(tables, accum, bstate, batch)
        workings = {n: ws.rows for n, ws in wss.items()}
        invs = {n: ws.inverse for n, ws in wss.items()}
        emb = self._embed(workings, invs, batch)
        return self._loss(dense0, emb, batch, predict=True), aux

    def _finish_predict(self, scores, aux) -> np.ndarray:
        # ONE device-to-host copy brings the scores and the lookup's serve
        # meters together
        keys = sorted(aux)
        packed = torch.cat([scores.reshape(-1).to(torch.float32)]
                           + [aux[k].reshape(1).to(torch.float32)
                              for k in keys]).cpu().numpy()
        n = scores.shape[0]
        c = self._serve_counters
        c["serve_requests"] = c.get("serve_requests", 0.0) + float(n)
        for k, v in zip(keys, packed[n:]):
            c[k] = c.get(k, 0.0) + float(v)
        return packed[:n]

    def serve_metrics(self) -> Dict[str, float]:
        """Cumulative SERVING-side counters: ``serve_requests`` (instances
        scored, tail pads included) and ``serve_lookups`` (id slots
        served)."""
        m = dict(self._serve_counters)
        for k, v in self.engine.store.serve_stats().items():
            m[f"serve_{k}"] = float(v)
        return m


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out
