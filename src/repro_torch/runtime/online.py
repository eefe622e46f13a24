"""Online predict-then-train loop (paper §5 evaluation protocol).

Counterpart of ``repro/runtime/online.py``: score each incoming batch with
the CURRENT model, then train on it — the production regime where every ad
impression is first served, then learned from.  Unlabeled streams skip the
scoring side and train only (``fit_online`` then returns ``auc=None``).

History records land in ``trainer.history`` exactly like ``fit``'s, plus an
``auc`` key for labeled streams.

``strict_transfers=True`` (the reference's ``jax.transfer_guard`` over the
hot path) is not honoured by the port and raises: the dedup's
``torch.unique`` reads its result size on the host every step (ROADMAP.md
§C).
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Tuple

from repro_torch.runtime.metrics import StreamingAUC
from repro_torch.runtime.trainer import history_record


def _format_record(rec: dict, steps_this_run: int) -> str:
    parts = [f"step {rec['step']:5d}", f"loss {rec['loss']:.4f}"]
    if "auc" in rec:
        parts.append(f"AUC {rec['auc']:.4f}")
    if rec.get("overflow_dropped", 0):
        parts.append(f"dropped {rec['overflow_dropped']}")
    # throughput of THIS run: rec["step"] is the global counter, but
    # rec["sec"] only spans this loop
    parts.append(f"{steps_this_run / max(rec['sec'], 1e-9):.1f} steps/s")
    return "  ".join(parts)


def fit_online(
    trainer,
    batches: Iterator,
    steps: int,
    window: int = 30,
    log=None,
    strict_transfers: bool = False,
) -> Tuple[list, Optional[float]]:
    """Predict-then-train ``steps`` batches; returns ``(history, auc)``.

    ``auc`` is the streaming AUC over the last ``window`` scored batches
    (``None`` when the stream carries no labels).  ``log`` (e.g. ``print``)
    receives one formatted line per ``TrainerConfig.log_every`` boundary.
    """
    if strict_transfers:
        raise NotImplementedError(
            "fit_online(strict_transfers=True) is not honoured by the port: "
            "the dedup's torch.unique syncs the host every step "
            "(ROADMAP.md §C)")
    meter = StreamingAUC(window=window)
    scored = False
    loss = None
    start_step = trainer.step_num
    t0 = time.perf_counter()

    def _record():
        rec = history_record(trainer, loss, t0)   # fit's record schema
        if scored:
            rec["auc"] = meter.value()
        trainer.history.append(rec)
        if log:
            log(_format_record(rec, trainer.step_num - start_step))

    for _ in range(steps):
        try:
            b = next(batches)
        except StopIteration:
            break   # finite stream shorter than steps: finish cleanly
        scores = trainer.predict(b) if "label" in b else None
        loss = trainer.train_step(b)
        if scores is not None:
            meter.update(b["label"], scores)
            scored = True
        if trainer.step_num % trainer.cfg.log_every == 0:
            _record()
    if loss is not None and (
        not trainer.history or trainer.history[-1]["step"] != trainer.step_num
    ):
        _record()   # short runs (steps < log_every) still get a final record
    return trainer.history, (meter.value() if scored else None)
