"""The hybrid trainer (dense tower + sparse tables).

Counterpart of ``repro/runtime/trainer.py``'s ``HybridTrainer``: the
paper's CTR regime, a dense tower under k-step Adam (podded replicas) and
giant sparse tables behind an ``EmbeddingEngine``.  One training step is
Algorithm 1's pull -> train -> push:

  1. stage the batch on the device;
  2. ``EmbeddingEngine.pull``: dedup the batch's ids into the working set
     and gather its rows (plus the zero drop row);
  3. per pod, the bags over the working set (the CUDA kernel) and the loss;
     backward through the bag's CUDA backward and autograd for the tower;
     the working-row gradients are summed over pods and divided by
     ``n_pod``, the dense gradients stay per pod;
  4. ``KStepAdam.step``: the local step, or the merge step every k steps;
  5. ``EmbeddingEngine.push``: the AdaGrad push (the CUDA kernel).

The dense parameters, the optimizer state, the tables and the accumulator
are updated in place (the port's counterpart of the reference's buffer
donation).  The loss comes back as a device tensor and the overflow counter
stays on the device; both reach the host only at logging boundaries
(``history_record``), as in the reference.

``predict`` scores a batch with pod 0's replica on the engine's READ-ONLY
lookup, so a co-located ``CTRServer`` changes nothing in training.  The
dense parameters keep the reference's leading pod dimension, so a state
exported from the reference loads unchanged (``repro_torch.interop``).

Not ported yet, and raising when asked for: ``prefetch`` (ROADMAP.md queue
A5), ``ckpt_dir`` (A3), ``merge_delay > 0`` and ``merge_quorum != 1.0``
(rejected as the reference rejects them), ``DenseTrainer`` (A10).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree_map
from repro_torch.core.embedding_engine import EmbeddingEngine
from repro_torch.core.kstep import (  # noqa: F401  (re-exported API)
    KStepAdam,
    KStepConfig,
    leaves,
    pod_replicate,
    pod_slice,
)
from repro_torch.core.sparse_optim import SparseAdagradConfig, SparseAdagradState

Tree = Any


@dataclasses.dataclass
class TrainerConfig:
    """The ``repro`` TrainerConfig fields the port reads."""
    n_pod: int = 1
    kstep: KStepConfig = dataclasses.field(default_factory=KStepConfig)
    sparse: SparseAdagradConfig = dataclasses.field(
        default_factory=SparseAdagradConfig)
    placement: str = "gather"       # sparse backend ("gather" is ported)
    capacity: Optional[int] = None  # working-set bound (None: arch default)
    prefetch: bool = False          # pull prefetch (not ported: A5)
    fused_kernels: Optional[bool] = None  # None = auto: the CUDA kernels on
                                          # the card, the plain versions on
                                          # the CPU (ops.resolve_fused)
    store: str = "host"             # cold tier ("host" is ported)
    ckpt_dir: Optional[str] = None  # checkpoints (not ported: A3)
    merge_quorum: float = 1.0       # reserved: only 1.0 (all pods)
    merge_delay: int = 0            # DenseTrainer only
    log_every: int = 50


def _reject_dead_knobs(cfg: TrainerConfig, trainer: str, merge_delay_ok: bool):
    """No-silent-config contract: a knob either works or raises."""
    if cfg.merge_quorum != 1.0:
        raise NotImplementedError(
            f"{trainer}: merge_quorum={cfg.merge_quorum} is not implemented "
            "(there is no straggler/failure detector yet — merges always "
            "run over all pods); set merge_quorum=1.0")
    if cfg.merge_delay < 0:
        raise ValueError(f"merge_delay must be >= 0, got {cfg.merge_delay}")
    if cfg.merge_delay > 0 and not merge_delay_ok:
        raise ValueError(
            f"{trainer} does not support merge_delay={cfg.merge_delay}: the "
            "sparse side synchronizes every step, so a delayed dense merge "
            "would shear the two halves of the model — use DenseTrainer, or "
            "merge_delay=0")
    if cfg.prefetch:
        raise NotImplementedError(
            f"{trainer}: prefetch=True is not ported yet (ROADMAP.md queue "
            "A5, prefetch)")
    if cfg.ckpt_dir is not None:
        raise NotImplementedError(
            f"{trainer}: ckpt_dir is not ported yet (ROADMAP.md queue A3, "
            "checkpointing)")


def next_pow2(n) -> int:
    """Smallest power of two >= n."""
    cap = 1
    while cap < n:
        cap <<= 1
    return cap


def pod_batch(batch: Dict[str, torch.Tensor],
              n_pod: int) -> Dict[str, torch.Tensor]:
    """Split a staged global batch into per-pod shards (leading pod dim;
    views, no copy)."""
    out = {}
    for k, x in batch.items():
        if x.shape[0] % n_pod:
            raise ValueError(f"batch[{k!r}] has {x.shape[0]} instances, not "
                             f"a multiple of n_pod={n_pod}")
        out[k] = x.reshape((n_pod, x.shape[0] // n_pod) + tuple(x.shape[1:]))
    return out


def history_record(trainer, loss, t0: float) -> dict:
    """One fit-history record at a logging boundary, shared by ``fit`` and
    ``runtime.online``: step/loss/sec plus the trainer's PER-INTERVAL sparse
    metrics (``advance=True`` moves the interval baseline forward).  The
    loss and the counters reach the host here."""
    rec = {"step": trainer.step_num, "loss": float(loss),
           "sec": time.perf_counter() - t0}
    sparse_metrics = getattr(trainer, "sparse_metrics", None)
    if sparse_metrics is not None:
        rec.update(sparse_metrics(advance=True))
    return rec


def _fit_loop(trainer, batches: Iterator, steps: int, eval_fn=None) -> list:
    """Shared fit(): train ``steps`` batches, log every ``log_every``."""
    if steps <= 0:
        return trainer.history
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = trainer.train_step(next(batches))
        if trainer.step_num % trainer.cfg.log_every == 0:
            rec = history_record(trainer, loss, t0)
            if eval_fn:
                rec["eval"] = eval_fn(trainer)
            trainer.history.append(rec)
    return trainer.history


class HybridTrainer:
    """Dense tower (k-step Adam, podded) + sparse tables behind an
    ``EmbeddingEngine``: the paper's production regime.

    Parameters
    ----------
    dense_params: the dense tower's parameter tree (un-podded).
    engine: owns TableSpecs, capacity, the sparse optimizer, the backend.
    embed_fn(workings, invs, batch): model inputs from the pulled rows
        (``invs[name]`` is the inverse map restricted to one pod's shard).
    loss_fn(dense, emb, batch, predict=False): the dense side
        (``predict=True`` returns scores).
    tables: the initialised tables in the backend's layout (e.g.
        ``engine.init(generator)``).
    state: a ``repro_torch.interop.ReferenceState`` (podded dense, tables,
        accumulator and, optionally, the k-step Adam state), in place of
        ``dense_params`` and ``tables``.
    device: where everything lives; CUDA unless the caller asks for "cpu".
    """

    def __init__(self, dense_params: Optional[Tree], engine: EmbeddingEngine,
                 embed_fn: Callable, loss_fn: Callable, cfg: TrainerConfig,
                 tables: Optional[Dict[str, torch.Tensor]] = None, *,
                 state=None, device="cuda"):
        self.cfg = cfg
        _reject_dead_knobs(cfg, "HybridTrainer", merge_delay_ok=False)
        self.n_pod = cfg.n_pod
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(f"engine lives on {engine.device}, trainer on "
                             f"{self.device}")
        self.engine = engine
        self.opt = KStepAdam(cfg.kstep, cfg.n_pod)
        accum = opt_state = None
        if state is not None:
            if dense_params is not None or tables is not None:
                raise ValueError("pass either state or dense_params/tables")
            self.dense = state.dense
            tables, accum = state.tables, state.accum
            opt_state = state.opt_state
            for leaf in leaves(self.dense):
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
        if opt_state is None:
            opt_state = self.opt.init(self.dense)
        elif (opt_state.ef is None) != (cfg.kstep.merge != "int8_ef"):
            raise ValueError(
                f"state.opt_state has ef={opt_state.ef is not None}, but "
                f"merge={cfg.kstep.merge!r} "
                f"{'needs' if cfg.kstep.merge == 'int8_ef' else 'has no'} "
                "error-feedback residual")
        self.opt_state = opt_state
        self.step_num = int(opt_state.step)
        # device-resident cumulative overflow counter (read on the host only
        # at logging boundaries)
        self._overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        self._metrics_prev: Dict[str, float] = {}
        self._metrics_base_step = self.step_num
        self._embed = embed_fn
        self._loss = loss_fn
        self._pull = engine.pull_stage()
        self.ckpt = None          # checkpoints: ROADMAP.md queue A3
        # serving-side meters, accumulated host-side per predict
        self._serve_counters: Dict[str, float] = {}
        self.history: list = []

    # -------------------------------------------------------------- training
    def pod_batch(self, batch):
        return pod_batch(batch, self.n_pod)

    def _stage(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def train_step(self, batch) -> torch.Tensor:
        """One pull -> train -> push step on ``batch``.  Returns the mean
        loss over pods as a DEVICE tensor (``float()`` it at logging
        boundaries)."""
        self.step_num += 1
        is_merge = (self.step_num % self.cfg.kstep.k) == 0
        staged = self._stage(batch)
        wss, tables, accum, bstate = self.engine.commit(self._pull(
            self.tables, self.sparse_state.accum, self.backend_state,
            self.engine.ids_from_batch(staged)))
        return self._train(is_merge, tables, accum, bstate, wss,
                           self.pod_batch(staged))

    def _train(self, merge: bool, tables, accum, bstate, wss, batch_podded):
        """Forward/backward on the working set, k-step Adam, push."""
        dense, workings, losses = self._forward(wss, batch_podded)
        dense_g, work_g = self._backward(dense, workings, losses)
        self.opt.step(self.dense, dense_g, self.opt_state, merge=merge)
        self.tables, accum, self.backend_state = self.engine.push(
            tables, accum, bstate, wss, work_g)
        self.sparse_state = self.sparse_state._replace(accum=accum)
        self._overflow += self.engine.overflow(wss)
        return losses.detach().sum() / self.n_pod

    def _forward(self, wss, batch_podded):
        """Per pod: the bags over the working set, then the loss.  Returns
        the differentiable leaves (dense, workings) and the (n_pod,) losses."""
        workings = {n: ws.rows.detach().requires_grad_(True)
                    for n, ws in wss.items()}
        dense = tree_map(lambda x: x.detach().requires_grad_(True), self.dense)
        invs = {n: ws.inverse.reshape(self.n_pod, -1) for n, ws in wss.items()}
        losses = []
        for p in range(self.n_pod):
            bp = {k: v[p] for k, v in batch_podded.items()}
            emb = self._embed(workings, {n: inv[p] for n, inv in invs.items()},
                              bp)
            losses.append(self._loss(pod_slice(dense, p), emb, bp))
        return dense, workings, torch.stack(losses)

    def _backward(self, dense, workings, losses):
        """Gradients: per pod for the dense tree, summed over pods and
        divided by ``n_pod`` for the working rows (the sparse side is
        synchronized every step)."""
        dense_leaves = leaves(dense)
        grads = torch.autograd.grad(losses.sum(),
                                    dense_leaves + list(workings.values()))
        it = iter(grads[:len(dense_leaves)])
        dense_g = tree_map(lambda _: next(it), dense)
        work_g = {n: g / self.n_pod
                  for n, g in zip(workings, grads[len(dense_leaves):])}
        return dense_g, work_g

    @property
    def overflow_dropped(self) -> int:
        """Cumulative unserved pull requests (reads the device counter)."""
        return int(self._overflow)

    def sparse_metrics(self, advance: bool = False) -> Dict[str, float]:
        """Sparse-path health PER INTERVAL (since the last logging
        boundary): ``overflow_dropped``, with the whole-run value under
        ``overflow_dropped_total``.  A pure read unless ``advance=True``
        (what the fit loggers pass), which moves the interval baseline."""
        total = int(self._overflow)
        m: Dict[str, float] = {
            "overflow_dropped": total - int(self._metrics_prev.get(
                "overflow", 0)),
            "overflow_dropped_total": total,
        }
        if advance:
            self._metrics_prev = {"overflow": total}
        return m

    def suggest_capacity(self, history=None, safety: float = 1.25) -> int:
        """Recommend a dedup capacity from observed overflow: with no drops
        the current capacity stands; otherwise the next power of two
        covering the current capacity plus ``safety`` x the worst observed
        per-step drop rate (PER-INTERVAL ``overflow_dropped`` records from
        ``history``, default this trainer's own)."""
        hist = self.history if history is None else history
        worst = 0.0
        prev_step = self._metrics_base_step if history is None else 0
        for rec in hist:
            if "overflow_dropped" not in rec:
                continue
            d_steps = rec["step"] - prev_step
            if d_steps > 0:
                worst = max(worst, rec["overflow_dropped"] / d_steps)
            prev_step = rec["step"]
        if not hist and self.step_num > 0:
            worst = self.overflow_dropped / self.step_num
        if worst <= 0:
            return self.engine.capacity
        return next_pow2(self.engine.capacity + safety * worst)

    def fit(self, batches: Iterator, steps: int, eval_fn=None) -> list:
        return _fit_loop(self, batches, steps, eval_fn)

    # --------------------------------------------------------------- serving
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
