"""Double-buffered pull prefetch: the paper's Fig. 5 pipeline for the PS pull.

Counterpart of ``repro/core/prefetch.py``.  Algorithm 1 runs pull ->
fwd/bwd -> push strictly in turn; the paper hides the pull behind the
accelerator's fwd/bwd work.  The pull is a ``(tables, accum, states) ->
(wss, tables, accum, states)`` transition, and the pull of batch t+1
commutes with the push of batch t except through those tensors, so issuing
it early and handing its outputs to the next step keeps the training bits.

``PrefetchingEngine`` wraps an ``EmbeddingEngine`` with a one-slot double
buffer:

    pf = PrefetchingEngine(engine)
    pending = pf.dispatch(tables, accum, states, batch, stage_fn)
        # EmbeddingEngine.pull_async: on the card the plan (staging and
        # dedup) runs on a side stream and overlaps the step still queued;
        # the table part follows on the main stream, after that step
    ...
    p = pf.commit()   # hand-off to the train stage

Invariants (all loud, never silent):
  - at most ONE pull is in flight (``dispatch`` while pending raises);
  - ``commit`` without a pending pull raises;
  - each ``PendingPull`` remembers the source batch object (``src``), so a
    trainer can detect being fed another batch than it prefetched;
  - the pending slot's ``tables``/``accum``/``bstate`` are the only valid
    handles until the commit (the port updates them in place, so they are
    the committed objects themselves, holding the same values: a pull moves
    rows coherently, only a push changes them); checkpoints are taken at
    commit boundaries only (``HybridTrainer.save`` enforces it).

On the DiskStore the engine's pull stage is the staged one, and
``dispatch`` runs it in the reference's order: host dedup and
``readahead`` of the next batch's pages first, then ``absorb_staged`` of
the previous step's outputs, which is the first wait for that step, so the
page faults overlap the step.  Inference never absorbs: ``predict`` runs
the read-only lookup, and on the DiskStore ``stage_lookup`` overlays the
pending staged outputs (a pending pull's pass-through rows patch
idempotently).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core.embedding_engine import EmbeddingEngine, WorkingSet


class PendingPull(NamedTuple):
    """One issued working-set pull.

    On the card its tensors are being computed on the streams: the plan on
    the side stream until ``event``, the table part on the main stream.
    ``tables``/``accum``/``bstate`` are the post-pull state, logically the
    committed state the pull consumed, so reads (an online ``predict``) may
    use them while the pull is in flight."""

    wss: Dict[str, WorkingSet]   # per-table pulled working sets
    tables: Dict[str, Any]       # post-pull tables (cache spills applied)
    accum: Dict[str, Any]        # post-pull AdaGrad accumulators
    bstate: Dict[str, Any]       # post-pull backend state (cache admissions)
    batch: Any                   # the device-staged batch the pull serves
    src: Any                     # the caller's batch object (identity key
                                 # for mismatch detection; keeps it alive)
    event: Optional[Any]         # the side stream's event after the plan
                                 # (None on the CPU)


class PrefetchingEngine:
    """One-slot (double-buffered) speculative pull dispatcher."""

    def __init__(self, engine: EmbeddingEngine):
        self.engine = engine
        self._pending: Optional[PendingPull] = None

    @property
    def pending(self) -> Optional[PendingPull]:
        return self._pending

    def dispatch(self, tables, accum, states, batch, stage) -> PendingPull:
        """Issue ``batch``'s pull against the committed sparse state
        (``EmbeddingEngine.pull_async``); ``stage`` puts the batch on the
        device.  The result lives in the pending slot until ``commit``,
        with ``batch`` itself as ``src`` for identity checks."""
        if self._pending is not None:
            raise RuntimeError(
                "PrefetchingEngine.dispatch: a pull is already in flight — "
                "train on it (commit()) before dispatching another "
                "(the prefetch pipeline is one batch deep)")
        wss, t, a, s, staged, event = self.engine.pull_async(
            tables, accum, states, batch, stage)
        self._pending = PendingPull(
            wss=wss, tables=t, accum=a, bstate=s, batch=staged,
            src=batch, event=event)
        return self._pending

    def commit(self) -> PendingPull:
        """Take the pending pull for the train stage (the serialization
        point: its tensors carry the only valid sparse state).  On the
        card the current stream waits on the plan's event."""
        p = self._pending
        if p is None:
            raise RuntimeError(
                "PrefetchingEngine.commit: no pull in flight — dispatch() "
                "one first (or run the synchronous pull path)")
        self._pending = None
        if p.event is not None:
            torch.cuda.current_stream(self.engine.device).wait_event(p.event)
        return p
