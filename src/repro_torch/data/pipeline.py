"""Host-side input pipeline with prefetch overlap.

Counterpart of ``repro/data/pipeline.py`` (the paper's pipelined Read-Ins
stage, §3.1 and Fig. 5): a background thread stages the next batches while
the device executes the current step, so input I/O overlaps compute.  Stage
timings are recorded (``read_seconds`` on the producer, ``wait_seconds`` on
the consumer).

On the card a ``stage_fn`` may copy each batch to the device from the
producer thread: ``CudaStager`` does it on a stream of its own, from pinned
memory, and returns a ``StagedBatch`` that carries the event recorded after
its copies.  ``stage_batch`` is the one staging path of the port (the
trainers stage through it too): given a ``StagedBatch`` it makes the
consuming stream wait on that event and ``record_stream``s the batch's
tensors onto it, so the caching allocator cannot hand a block out again
while a stream still reads it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


class _ProducerFailure:
    """In-band envelope shipping a producer-thread exception to the
    consumer: the producer must never die silently."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchPipeline:
    """Wrap a batch iterator with a depth-bounded background prefetcher.

    Producer-thread failures (a raising ``source`` or ``stage_fn``) are
    captured and re-raised by ``__next__`` on the consumer thread, on that
    call and every later one: a dead producer surfaces as an exception at
    the next batch, not as a silent end of the stream.
    """

    def __init__(self, source: Iterator[Any], depth: int = 2,
                 stage_fn: Optional[Callable[[Any], Any]] = None):
        self.source = source
        self.stage_fn = stage_fn or (lambda b: b)
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.read_seconds = 0.0       # producer-side time (read + staging)
        self.wait_seconds = 0.0       # consumer-side stall (pipeline bubble)
        self.batches = 0
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that keeps honouring ``close()``; False = shut down."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            for item in self.source:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                staged = self.stage_fn(item)
                self.read_seconds += time.perf_counter() - t0
                if not self._put(staged):
                    return
            self._put(None)   # clean end-of-stream sentinel
        except BaseException as e:   # re-raised by __next__ on the consumer
            self._put(_ProducerFailure(e))

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_seconds += time.perf_counter() - t0
        self.batches += 1
        if item is None:
            raise StopIteration
        if isinstance(item, _ProducerFailure):
            # keep the failure in-band so every later next() re-raises
            # instead of blocking on a queue the dead producer never feeds
            self._q.put(item)
            raise RuntimeError(
                "PrefetchPipeline producer failed") from item.exc
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # joined, not abandoned: shutdown is ordered after the producer's
        # last queue operation (its put loop sees _stop within 100 ms)
        self._thread.join(timeout=30)


def serialized_baseline(source: Iterator[Any], stage_fn, n: int):
    """No-overlap reference (the paper's "without pipeline" column): stage
    each batch inline.  Returns (batches, staging_seconds)."""
    out, total = [], 0.0
    for _ in range(n):
        item = next(source)
        t0 = time.perf_counter()
        out.append(stage_fn(item))
        total += time.perf_counter() - t0
    return out, total


# ------------------------------------------------------------ device staging
class StagedBatch(dict):
    """A batch already on the card, copied on another stream; ``ready`` is
    the event recorded on that stream after its copies."""

    ready: Optional["torch.cuda.Event"] = None


def stage_batch(batch, device) -> Dict[str, torch.Tensor]:
    """``batch`` (numpy arrays, CPU or device tensors) on ``device``, on the
    current stream: host leaves go to the card from pinned memory without a
    wait (the caching host allocator keeps the pinned block until the copy
    is done); leaves already on the card stay where they are.  A
    ``StagedBatch`` is waited for on the current stream and its tensors
    are recorded onto it."""
    device = torch.device(device)
    ready = getattr(batch, "ready", None)
    stream = None
    if ready is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ready)
    out = {}
    for k, x in batch.items():
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        if t.device.type != device.type:
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
        elif stream is not None:
            t.record_stream(stream)
        out[k] = t
    return out


class CudaStager:
    """A pipeline ``stage_fn`` that copies each host batch to the card on a
    stream of its own (made on the first call, in the producer thread) and
    returns a ``StagedBatch`` whose ``ready`` event the consumer waits on
    (``stage_batch``)."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._stream = None

    def __call__(self, batch) -> StagedBatch:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = StagedBatch(stage_batch(batch, self.device))
            out.ready = torch.cuda.Event()
            out.ready.record(self._stream)
        return out
