"""The training runtimes: ``DenseTrainer`` (all-dense models: the LM) and
``HybridTrainer`` (dense tower + sparse tables).

``DenseTrainer`` is the reference's: podded replicas of every parameter
under k-step Adam, each pod's loss on its own replica and its own share of
the batch, one backward of the summed loss (the reference's ``jax.grad``
of the vmapped sum), the local step or the merge step every k steps, and
with ``merge_delay > 0`` the delayed merge (each boundary's pod average
applied ``merge_delay`` boundaries late, keeping the local drift since its
snapshot).  Parameters, gradients and optimizer state are updated in
place; the gradients land in one podded buffer per leaf, each pod's
accumulated into its slice as autograd produces it (``.grad`` of the pod's
view), so no second copy of the gradient tree is ever live.  The batch
goes to the card from pinned memory without a wait, and the mean loss
comes back as a device tensor: a step makes no host sync.

``HybridTrainer`` is ``repro/runtime/trainer.py``'s ``HybridTrainer``: the
paper's CTR regime, a dense tower under k-step Adam (podded replicas) and
giant sparse tables behind an ``EmbeddingEngine``.  One training step is
Algorithm 1's pull -> train -> push:

  1. stage the batch on the device;
  2. ``EmbeddingEngine.pull``: dedup the batch's ids into the working set
     and gather its rows (plus the zero drop row); under the cached
     placement through the device cache (``core.cache_tier``);
  3. per pod, the model's inputs from the working set (the bags, the CUDA
     kernel; DLRM's 26 single-hot takes are bags of one id) and the loss;
     backward through the bag's CUDA backward (DLRM: and the interaction's)
     and autograd for the rest; the working-row gradients are summed over
     pods and divided by ``n_pod``, the dense gradients stay per pod;
  4. ``KStepAdam.step``: the local step, or the merge step every k steps;
  5. ``EmbeddingEngine.push``: the AdaGrad push (the CUDA kernel; under
     the cached placement the cached push into the device cache; under the
     DiskStore the staged push over the staged rows).

Under the DiskStore (``store="disk"``, the SSD tier) the pull is the
engine's staged pull (``EmbeddingEngine.disk_pull``): the tables live in
page files, and ``self.tables``/the accumulator hold the last step's
staged ``(capacity, dim)`` rows until the next pull commits them.

The dense parameters, the optimizer state, the tables and the accumulator
are updated in place (the port's counterpart of the reference's buffer
donation).  The loss comes back as a device tensor and the overflow counter
stays on the device; both reach the host only at logging boundaries
(``history_record``), as in the reference.

``predict`` scores a batch with pod 0's replica on the engine's READ-ONLY
lookup, so a co-located ``CTRServer`` changes nothing in training.  The
dense parameters keep the reference's leading pod dimension, so a state
exported from the reference loads unchanged (``repro_torch.interop``).

Fault tolerance (the reference's): with ``ckpt_dir`` a trainer saves its
state every ``ckpt_every`` steps through ``checkpoint.CheckpointManager``
(the reference's layout and leaf names, written in a background
thread), and ``resume()`` restores the newest complete
checkpoint into the live tensors, in place.  ``DenseTrainer`` saves
params, m, v_local, v_hat (and ef under ``int8_ef``; a checkpoint without
it resumes with a fresh residual); the delayed merges in flight are not
saved, so a resume starts with none, as in the reference.
``HybridTrainer`` saves the dense tree, the tables, the accumulator, the
moments, the backend's state (the cached placement's device cache, which
is not flushed first: the reference does not flush there) and the
overflow counter, with the placement's signature in the manifest, which a
resume checks; under the DiskStore a save syncs the store and snapshots
its pages into the checkpoint, and a resume restores them first.

With ``TrainerConfig.prefetch`` a ``HybridTrainer`` issues batch t+1's
pull right after batch t's step is queued (``core.prefetch``, the paper's
Fig. 5 overlap): ``fit`` runs one batch ahead and calls ``prefetch``, and
``train_step`` commits the pending pull instead of pulling.  On the card
the pull's plan (the batch's staging and dedup) runs on a side stream and
the table part on the main stream after the step, so prefetched training
is bit-identical to synchronous training; on the DiskStore the next
batch's read-ahead is queued before the previous step's outputs are
absorbed.  After a dispatch the trainer's ``tables``, accumulator and
``backend_state`` are the pending pull's, so ``predict`` works mid-flight;
``save`` raises while a pull is in flight.  ``DenseTrainer`` rejects
``prefetch`` (it has no pull), and ``merge_delay > 0`` (``HybridTrainer``)
and ``merge_quorum != 1.0`` are rejected, as the reference rejects them.
Batches are staged through ``data.pipeline.stage_batch``: pinned memory
and a copy without a wait, or a ``StagedBatch`` from the input pipeline
waited for on its event.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import shutil
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree_map
from repro_torch.checkpoint import CheckpointManager, latest_step, read_manifest
from repro_torch.checkpoint.ckpt import copy_tree_
from repro_torch.core.embedding_engine import EmbeddingEngine
from repro_torch.core.kstep import (  # noqa: F401  (re-exported API)
    KStepAdam,
    KStepConfig,
    leaves,
    pod_replicate,
    pod_slice,
)
from repro_torch.core.prefetch import PrefetchingEngine
from repro_torch.core.sparse_optim import SparseAdagradConfig, SparseAdagradState
from repro_torch.data.pipeline import stage_batch

Tree = Any


@dataclasses.dataclass
class TrainerConfig:
    """The ``repro`` TrainerConfig fields the port reads."""
    n_pod: int = 1
    kstep: KStepConfig = dataclasses.field(default_factory=KStepConfig)
    sparse: SparseAdagradConfig = dataclasses.field(
        default_factory=SparseAdagradConfig)
    placement: str = "gather"       # sparse backend: "gather" | "cached"
    capacity: Optional[int] = None  # working-set bound (None: arch default)
    cache_rows: Optional[int] = None  # device cache size for "cached"
                                      # (None: the capacity)
    prefetch: bool = False          # double-buffered pull prefetch
                                    # (HybridTrainer only; Fig. 5 overlap)
    fused_kernels: Optional[bool] = None  # None = auto: the CUDA kernels on
                                          # the card, the plain versions on
                                          # the CPU (ops.resolve_fused)
    store: str = "host"             # cold tier: "host" (resident tables)
                                    # | "disk" (paged spill dir)
    spill_dir: Optional[str] = None   # page directory (required for "disk")
    page_rows: Optional[int] = None   # rows per page file (None: 1024)
    page_cache_pages: Optional[int] = None  # RAM page-cache capacity
                                            # (None: unbounded)
    ckpt_dir: Optional[str] = None  # checkpoints (None: none)
    ckpt_every: int = 200
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


def _drop_ef_if_absent(like: dict, ckpt: CheckpointManager) -> dict:
    """Restoring with merge="int8_ef" must tolerate checkpoints written
    without the residual (older runs, or runs under a lossless merge): drop
    'ef' from the restore template when the newest manifest lacks it, so
    resume keeps the fresh zero residual."""
    if "ef" not in like:
        return like
    step = latest_step(ckpt.directory)
    man = read_manifest(ckpt.directory, step) if step is not None else None
    if man is not None and not any(
        k.split("/")[0] == "ef" for k in man["leaves"]
    ):
        like = dict(like)
        like.pop("ef")
    return like


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
    """Shared fit(): train ``steps`` batches, log every ``log_every``.

    Runs one batch ahead of the device: the next batch is drawn while the
    step executes and, when the trainer prefetches (``cfg.prefetch``), its
    pull is issued as soon as the current step is queued.  Checkpoints
    (inside ``train_step``) and logged metrics both come BEFORE the next
    pull is issued, so they capture the committed state, never a
    speculative pull.  The async checkpoint writer is waited for at exit."""
    if steps <= 0:
        if trainer.ckpt:
            trainer.ckpt.wait()   # fit(gen, 0) still flushes async saves
        return trainer.history
    t0 = time.perf_counter()
    prefetch = getattr(trainer, "prefetch", None)
    b = next(batches)
    if prefetch is not None:
        prefetch(b)
    for i in range(steps):
        loss = trainer.train_step(b)
        b = next(batches) if i + 1 < steps else None
        if trainer.step_num % trainer.cfg.log_every == 0:
            rec = history_record(trainer, loss, t0)
            if eval_fn:
                rec["eval"] = eval_fn(trainer)
            trainer.history.append(rec)
        if prefetch is not None and b is not None:
            prefetch(b)
    if trainer.ckpt:
        trainer.ckpt.wait()
    return trainer.history


class DenseTrainer:
    """All-dense models: k-step Adam over podded replicas.

    Parameters
    ----------
    loss_fn(params, batch) -> 0-dim float32 loss, for one pod's replica and
        its share of the batch.
    params: the parameter tree, un-podded (``podded=False``, replicated
        ``cfg.n_pod`` times) or already carrying the leading pod dimension.
    opt_state: a ``KStepAdamState`` to start from (None: a fresh one).
    device: where everything lives; CUDA unless the caller asks for "cpu".
    """

    def __init__(self, loss_fn: Callable, params: Tree, cfg: TrainerConfig,
                 *, opt_state=None, podded: bool = False, device="cuda"):
        self.cfg = cfg
        if cfg.prefetch:
            raise ValueError(
                "DenseTrainer: prefetch=True is a sparse-path feature "
                "(HybridTrainer's pull prefetch) — an all-dense model has "
                "no pull stage to overlap; set prefetch=False")
        _reject_dead_knobs(cfg, "DenseTrainer", merge_delay_ok=True)
        if cfg.fused_kernels:
            raise ValueError(
                "DenseTrainer: fused_kernels=True is a sparse-path feature "
                "(the fused embedding pull/push kernels) — an all-dense "
                "model has no working set to fuse over; leave "
                "fused_kernels=None")
        if (cfg.store != "host" or cfg.spill_dir is not None
                or cfg.page_rows is not None
                or cfg.page_cache_pages is not None):
            raise ValueError(
                "DenseTrainer: store/spill_dir/page_rows/page_cache_pages "
                "are sparse-path knobs (the embedding tables' storage "
                "hierarchy) — an all-dense model has no tables to spill")
        if cfg.merge_delay > 0 and cfg.kstep.merge == "int8_ef":
            raise NotImplementedError(
                "merge_delay>0 with merge='int8_ef' is not supported: the "
                "error-feedback residual needs the fused merge path")
        self.n_pod = cfg.n_pod
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.params = (params if podded
                       else pod_replicate(params, self.n_pod))
        for leaf in leaves(self.params):
            if leaf.shape[0] != self.n_pod or leaf.device != self.device:
                raise ValueError(
                    f"a podded leaf is {tuple(leaf.shape)} on {leaf.device}; "
                    f"expected {self.n_pod} pod replicas on {self.device}")
        self.opt = KStepAdam(cfg.kstep, cfg.n_pod)
        if opt_state is None:
            opt_state = self.opt.init(self.params)
        elif (opt_state.ef is None) != (cfg.kstep.merge != "int8_ef"):
            raise ValueError(
                f"opt_state has ef={opt_state.ef is not None}, but "
                f"merge={cfg.kstep.merge!r} "
                f"{'needs' if cfg.kstep.merge == 'int8_ef' else 'has no'} "
                "error-feedback residual")
        self.opt_state = opt_state
        self.step_num = int(opt_state.step)
        # one podded gradient buffer per leaf, in the leaf's dtype
        self.grads = tree_map(torch.zeros_like, self.params)
        self._loss_fn = loss_fn
        # merge_delay > 0: queue of (snapshot, in-flight merged average)
        self._pending_merges: collections.deque = collections.deque()
        self.ckpt = (CheckpointManager(cfg.ckpt_dir,
                                       save_every=cfg.ckpt_every,
                                       async_save=True)
                     if cfg.ckpt_dir else None)
        self.history: list = []

    def pod_batch(self, batch):
        return pod_batch(batch, self.n_pod)

    def _forward(self, batch_podded):
        """Each pod's loss on its replica (a view of the podded leaves, its
        ``.grad`` the pod's slice of ``self.grads``, zeroed); returns the
        (n_pod,) losses, the views and their slices' addresses."""
        grads = leaves(self.grads)
        for g in grads:
            g.zero_()
        views, inputs, slots = [], [], []   # slots: the slices' addresses
        for i in range(self.n_pod):
            view = tree_map(lambda x: x[i].detach().requires_grad_(True),
                            self.params)
            for v, g in zip(leaves(view), grads):
                v.grad = g[i]
                inputs.append(v)
                slots.append(v.grad.data_ptr())
            views.append(view)
        losses = torch.stack([
            self._loss_fn(views[i], {k: x[i] for k, x in batch_podded.items()})
            for i in range(self.n_pod)])
        return losses, inputs, slots

    @staticmethod
    def _backward(losses, inputs, slots) -> torch.Tensor:
        """One backward of the pods' summed loss, each pod's gradient added
        into its slice of ``self.grads``; returns the losses, detached."""
        torch.autograd.backward(losses.sum(), inputs=inputs)
        # autograd adds into an existing .grad in place; a replaced one
        # would leave the buffer without this step's gradient
        for v, ptr in zip(inputs, slots):
            if v.grad is None or v.grad.data_ptr() != ptr:
                raise RuntimeError("a pod's gradient did not land in its "
                                   "slice of the gradient buffer")
        return losses.detach()

    def train_step(self, batch, podded: bool = False) -> torch.Tensor:
        """One step on ``batch`` (``podded=True``: its leaves already carry
        the leading pod dimension).  Returns the mean loss over pods as a
        DEVICE tensor (``float()`` it at logging boundaries)."""
        self.step_num += 1
        is_boundary = (self.step_num % self.cfg.kstep.k) == 0
        fused_merge = is_boundary and self.cfg.merge_delay == 0
        staged = stage_batch(batch, self.device)
        pb = staged if podded else self.pod_batch(staged)
        losses = self._backward(*self._forward(pb))
        self.opt.step(self.params, self.grads, self.opt_state,
                      merge=fused_merge)
        if is_boundary and self.cfg.merge_delay > 0:
            self._delayed_merge_boundary()
        if self.ckpt and self.ckpt.should_save(self.step_num):
            self.save()
        return losses.mean()

    def _delayed_merge_boundary(self):
        """``merge_delay > 0``: at each merge boundary, first apply the
        average launched ``merge_delay`` boundaries ago (keeping the local
        drift since its snapshot), then launch this boundary's: the
        parameter average and the ``v_hat <- mean v_local`` refresh, which
        applies now."""
        if len(self._pending_merges) >= self.cfg.merge_delay:
            snap_old, merged_old = self._pending_merges.popleft()
            KStepAdam.apply_delayed_merge(self.params, snap_old, merged_old)
        snap = KStepAdam.snapshot(self.params)
        merged, self.opt_state = self.opt.delayed_merge_collective(
            self.params, self.opt_state)
        self._pending_merges.append((snap, merged))

    def fit(self, batches: Iterator, steps: int, eval_fn=None) -> list:
        return _fit_loop(self, batches, steps, eval_fn)

    # ----------------------------------------------------- fault tolerance
    def _ckpt_tree(self):
        tree = {"params": self.params, "m": self.opt_state.m,
                "v_local": self.opt_state.v_local,
                "v_hat": self.opt_state.v_hat}
        if self.opt_state.ef is not None:
            # int8_ef merge: the error-feedback residual is state — dropping
            # it on restart silently re-zeros the compensation.
            tree["ef"] = self.opt_state.ef
        return tree

    def save(self):
        self.ckpt.save(self.step_num, self._ckpt_tree(),
                       meta={"n_pod": self.n_pod, "k": self.cfg.kstep.k})

    def resume(self) -> bool:
        """Restore the newest complete checkpoint into the live state, in
        place; False when there is none."""
        if not self.ckpt:
            return False
        like = _drop_ef_if_absent(self._ckpt_tree(), self.ckpt)
        step, tree = self.ckpt.restore_latest(like)
        if step is None:
            return False
        copy_tree_(like, tree)
        self.step_num = step
        self.opt_state.step.fill_(step)
        self._pending_merges.clear()   # in-flight delayed merges don't resume
        return True


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
        accum = opt_state = bstate = None
        if state is not None:
            if dense_params is not None or tables is not None:
                raise ValueError("pass either state or dense_params/tables")
            self.dense = state.dense
            # the placement decides where the tables live (the cached one
            # keeps them, and so the accumulator, in host memory)
            tables = engine.prepare(state.tables)
            accum = {n: a.to(tables[n].device) for n, a in state.accum.items()}
            opt_state = state.opt_state
            bstate = state.backend_state
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
        disk = engine.store.kind == "disk"
        for name, spec in engine.specs.items():
            # under the DiskStore the "tables" are the staging buffers
            want = ((engine.capacity if disk else spec.rows), spec.dim)
            if tuple(tables[name].shape) != want:
                raise ValueError(
                    f"table {name!r} is {tuple(tables[name].shape)}, "
                    f"expected {want}")
        self.tables = tables
        self.sparse_state = (engine.init_state(tables) if accum is None
                             else SparseAdagradState(accum))
        self.backend_state = (engine.init_backend_state(tables)
                              if bstate is None else bstate)
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
        # the one-slot pull prefetcher (cfg.prefetch): the same pull code,
        # issued one batch early
        self._prefetcher = (PrefetchingEngine(engine) if cfg.prefetch
                            else None)
        # the checkpoint GC doubles as the spill-dir wreckage sweeper when
        # the engine's tables live in a DiskStore
        self.ckpt = (
            CheckpointManager(
                cfg.ckpt_dir, save_every=cfg.ckpt_every,
                async_save=True,
                spill_dir=getattr(engine.store, "spill_dir", None))
            if cfg.ckpt_dir else None)
        # serving-side meters, accumulated host-side per predict
        self._serve_counters: Dict[str, float] = {}
        self.history: list = []

    # -------------------------------------------------------------- training
    def pod_batch(self, batch):
        return pod_batch(batch, self.n_pod)

    def _stage(self, batch) -> Dict[str, torch.Tensor]:
        """``batch`` on the device, on the current stream (host leaves from
        pinned memory without a wait; device leaves as they are; a
        ``StagedBatch`` waited for)."""
        return stage_batch(batch, self.device)

    def prefetch(self, batch) -> bool:
        """Issue ``batch``'s working-set pull ahead of its step (the Fig. 5
        overlap).  No-op unless ``cfg.prefetch``; idempotent for the batch
        already in flight; a DIFFERENT batch while one is pending is a
        pipeline bug and raises.  After the dispatch the trainer's sparse
        state handles are the pull's outputs (the same values: a pull moves
        rows coherently, only a push changes them), so ``predict`` works
        mid-flight."""
        if self._prefetcher is None or batch is None:
            return False
        pending = self._prefetcher.pending
        if pending is not None:
            if pending.src is batch:
                return True
            raise RuntimeError(
                "HybridTrainer.prefetch: a pull for a different batch is "
                "already in flight — train_step() it before prefetching "
                "the next batch (the pipeline is one batch deep)")
        pending = self._prefetcher.dispatch(
            self.tables, self.sparse_state.accum, self.backend_state, batch,
            self._stage)
        self.tables = pending.tables
        self.backend_state = pending.bstate
        self.sparse_state = self.sparse_state._replace(accum=pending.accum)
        return True

    def train_step(self, batch) -> torch.Tensor:
        """One pull -> train -> push step on ``batch``.

        Uses the prefetched pull when one is in flight (``cfg.prefetch``;
        on a cold start it pulls now), otherwise pulls synchronously: the
        same code either way.  Returns the mean loss over pods as a DEVICE
        tensor (``float()`` it at logging boundaries)."""
        if self._prefetcher is not None:
            pending = self._prefetcher.pending
            # reject BEFORE any state moves (step_num included): a caught
            # misuse error must not shift the merge/checkpoint cadence
            if pending is not None and pending.src is not batch:
                raise RuntimeError(
                    "HybridTrainer.train_step: the in-flight prefetched pull "
                    "belongs to a different batch than the one passed — "
                    "feed the same batch to prefetch() and train_step()")
        self.step_num += 1
        is_merge = (self.step_num % self.cfg.kstep.k) == 0
        if self._prefetcher is not None:
            if self._prefetcher.pending is None:
                self.prefetch(batch)   # cold start: pull now (not early)
            p = self._prefetcher.commit()
            wss, staged = p.wss, p.batch
            tables, accum, bstate = p.tables, p.accum, p.bstate
        else:
            staged = self._stage(batch)
            wss, tables, accum, bstate = self.engine.commit(self._pull(
                self.tables, self.sparse_state.accum, self.backend_state,
                self.engine.ids_from_batch(staged)))
        loss = self._train(is_merge, tables, accum, bstate, wss,
                           self.pod_batch(staged))
        if self.ckpt and self.ckpt.should_save(self.step_num):
            self.save()   # the committed state: the next pull is not queued
        return loss

    def train_step_prefetched(self, batch, next_batch=None) -> torch.Tensor:
        """One pipelined step for manual (non-``fit``) loops: train on
        ``batch`` (its prefetched pull, or a pull now on a cold start),
        then issue ``next_batch``'s pull so it overlaps the step just
        queued."""
        loss = self.train_step(batch)
        if next_batch is not None:
            self.prefetch(next_batch)
        return loss

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
        boundary): ``overflow_dropped`` and, under the cached placement,
        ``cache_hit_rate``, ``evictions`` and the host <-> device byte
        meters, under the DiskStore ``page_hit_rate``, ``pages_evicted``
        and the disk byte meters; the whole-run values under ``*_total``
        keys.  A pure read
        unless ``advance=True`` (what the fit loggers pass), which moves the
        interval baseline."""
        total = int(self._overflow)
        counters = self.engine.cache_counters(self.backend_state)
        prev = self._metrics_prev
        m: Dict[str, float] = {
            "overflow_dropped": total - int(prev.get("overflow", 0)),
            "overflow_dropped_total": total,
        }
        if counters:
            delta = {k: v - prev.get(k, 0.0) for k, v in counters.items()}
            m.update(self.engine.derive_cache_stats(delta))
            for k, v in self.engine.derive_cache_stats(counters).items():
                m[f"{k}_total"] = v
        if advance:
            self._metrics_prev = {"overflow": total, **counters}
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

    # ----------------------------------------------------- fault tolerance
    def _ckpt_tree(self):
        tree = {"dense": self.dense, "tables": self.tables,
                "accum": self.sparse_state.accum, "m": self.opt_state.m,
                "v_local": self.opt_state.v_local,
                "v_hat": self.opt_state.v_hat}
        if self.opt_state.ef is not None:
            tree["ef"] = self.opt_state.ef
        if any(s for s in self.backend_state.values()):
            # cache-tier state is training state: host tables alone are
            # stale while rows sit dirty in the device cache, so the cache
            # roundtrips with them (not flushed first, as in the reference)
            tree["bstate"] = self.backend_state
        # the overflow counter rides along so post-resume *_total metrics
        # share one baseline with the cache counters living in bstate
        tree["overflow"] = self._overflow
        return tree

    def _backend_sig(self):
        """Identity of the sparse physical layout baked into the tables
        (+ cache geometry, which shapes the checkpointed backend state)."""
        b = self.engine.backend
        sig = {"backend": type(b).__name__,
               "n_shards": getattr(b, "n_shards", 1),
               "store": self.engine.store.kind}
        cache_rows = getattr(b, "cache_rows", None)
        if cache_rows is not None:
            sig["cache_rows"] = int(cache_rows)
        if self.engine.store.kind == "disk":
            # page geometry shapes the checkpoint's page files
            sig["page_rows"] = int(self.engine.store.page_rows)
        return sig

    def save(self):
        if (self._prefetcher is not None
                and self._prefetcher.pending is not None):
            # a checkpoint captures the committed (post-push) state: the
            # speculative pull's cache admissions would double-count on
            # resume.  fit/train_step save at commit boundaries, before the
            # next pull is issued.
            raise RuntimeError(
                "HybridTrainer.save: a prefetched pull is in flight — "
                "checkpoints capture committed state only; save at step "
                "boundaries (as fit/train_step do) before prefetching")
        extras_dir = None
        if self.engine.store.kind == "disk":
            # commit everything in flight to the store, then snapshot its
            # pages SYNCHRONOUSLY into a staging dir — the async writer only
            # renames the finished snapshot into the checkpoint, so live
            # page mutations after this point can't tear it.  The staged
            # buffers in the tree stay consistent with the snapshot:
            # re-absorbing them on resume rewrites the same values.
            self.engine.sync_store(
                self.tables, self.sparse_state.accum, self.backend_state)
            extras_dir = os.path.join(
                self.ckpt.directory, f"pages_staging_{self.step_num}")
            if os.path.exists(extras_dir):
                shutil.rmtree(extras_dir)
            self.engine.store.snapshot_to(extras_dir)
        self.ckpt.save(
            self.step_num, self._ckpt_tree(),
            meta={"n_pod": self.n_pod, "k": self.cfg.kstep.k,
                  **self._backend_sig()},
            extras_dir=extras_dir)

    def resume(self) -> bool:
        """Restore the newest complete checkpoint into the live state, in
        place; False when there is none.  Raises when it was written under
        another placement, shard count, cache size, store or page size."""
        if not self.ckpt:
            return False
        # Tables are checkpointed in the backend's physical layout; loading
        # them under a different backend (or a cached run's host tables,
        # which are stale wherever rows sat dirty in the device cache)
        # would silently read wrong rows.
        s = latest_step(self.ckpt.directory)
        man = read_manifest(self.ckpt.directory, s) if s is not None else None
        if man is not None and "backend" in man.get("meta", {}):
            sig = self._backend_sig()
            saved = {k: man["meta"][k]
                     for k in ("backend", "n_shards", "cache_rows",
                               "store", "page_rows")
                     if k in man["meta"]}
            # pre-store checkpoints carry no "store" key — they were host
            # runs, so only a disk-configured engine must refuse them
            if saved != {k: sig.get(k) for k in saved} or (
                "cache_rows" in sig and "cache_rows" not in saved
            ) or (sig["store"] == "disk" and "store" not in saved):
                raise ValueError(
                    f"checkpoint written with {saved} but the current engine "
                    f"uses {sig}: the tables' physical "
                    f"layouts differ — resume with the saving placement, or "
                    f"export/re-prepare the tables explicitly")
        like = _drop_ef_if_absent(self._ckpt_tree(), self.ckpt)
        if man is not None and not any(
            k.split("/")[0] == "overflow" for k in man["leaves"]
        ):
            like.pop("overflow", None)   # a checkpoint without the counter
            self._overflow.zero_()
        step, tree = self.ckpt.restore_latest(like)
        if step is None:
            return False
        if self.engine.store.kind == "disk":
            # pages first: the restored staged buffers are only consistent
            # against the SAVE-TIME pages
            self.engine.store.restore_from(os.path.join(
                self.ckpt.directory, f"step_{step:010d}", "pages"))
            self.engine.reset_staging()
        copy_tree_(like, tree)
        self.step_num = step
        self.opt_state.step.fill_(step)
        # re-baseline the interval snapshot so the first post-resume window
        # reports only post-resume deltas (totals keep the whole-run
        # baseline, matching the cache counters restored inside bstate)
        self._metrics_prev = {
            "overflow": int(self._overflow),
            **self.engine.cache_counters(self.backend_state),
        }
        return True

    # --------------------------------------------------------------- serving
    def predict(self, batch) -> np.ndarray:
        """Scores of a batch with pod 0's dense replica, on the engine's
        READ-ONLY lookup: the rows a pull would serve, with nothing
        written.

        Under the DiskStore the training staging buffers hold another
        batch's rows, so predict stages this batch's own through
        ``engine.stage_lookup``: serve-metered page reads with the pending
        staged training outputs (un-absorbed pushed rows, in-flight cache
        spills) laid over them on the host, so the freshest values are
        served and nothing is written to the store."""
        with torch.inference_mode():
            staged = self._stage(batch)
            tables, accum = self.tables, self.sparse_state.accum
            if self.engine.store.kind == "disk":
                ids = self.engine.ids_from_batch(staged)
                tables, accum = self.engine.stage_lookup(
                    tables, accum, self.backend_state,
                    {n: x.cpu().numpy() for n, x in ids.items()})
            scores, aux = self._predict_traced(
                self.dense, tables, accum, self.backend_state, staged)
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
        scored, tail pads included), ``serve_lookups`` (id slots served)
        and, under the cached placement, ``serve_misses`` and
        ``serve_hit_rate`` (``1 - misses / lookups``, as in training).
        Under the DiskStore the page meters of serving reads ride along as
        ``serve_page_*``/``serve_disk_*``."""
        m = dict(self._serve_counters)
        if "serve_misses" in m:
            lk = m.get("serve_lookups", 0.0)
            m["serve_hit_rate"] = (
                0.0 if lk <= 0.0 else 1.0 - m["serve_misses"] / lk)
        for k, v in self.engine.store.serve_stats().items():
            m[f"serve_{k}"] = float(v)
        return m

    def close(self) -> None:
        """Commit everything to the store and close it (the DiskStore:
        ``sync_store``, then stop its threads; nothing for the host
        store).  With a prefetched pull pending the store ends as after the
        synchronous run: the pull's staged rows are the store's own values,
        and absorbing them again is idempotent."""
        if self.engine.store.kind == "disk":
            self.engine.sync_store(self.tables, self.sparse_state.accum,
                                   self.backend_state)
            self.engine.store.close()
