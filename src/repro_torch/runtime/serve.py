"""Batched LM serving loop: prefill + decode with a static-slot batch
(``repro/runtime/serve.py``).

A minimal continuous-batching server: requests occupy slots; finished slots
(EOS or max tokens) are refilled from the queue between decode steps.  The
device-side ``decode_step`` is one function regardless of slot occupancy
(inactive slots decode padding and are ignored host-side).  The cache lives
on the parameters' device.

Kept from the reference as it is, fault included (ROADMAP.md §C): every
slot shares one ``t`` and ``pos``, and ``_fill_slots`` decodes every slot
for each prompt token, so requests interfere; the port's server is held to
the reference's server on the same sequence of requests, not to an
idealised one.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (P,) int32
    max_new_tokens: int = 16
    out: Optional[List[int]] = None


class BatchedServer:
    def __init__(self, params, cfg: tfm.TransformerConfig, slots: int,
                 max_len: int, eos_id: int = -1, greedy: bool = True):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache = tfm.init_cache(cfg, slots, max_len,
                                    device=params["embed"].device)
        # decode_step rewrites the cache in place (the reference jit donates
        # it), so one cache is live at a time, never two.
        self._decode = lambda p, c, t: tfm.decode_step(p, c, t, cfg)
        self.active: List[Optional[Request]] = [None] * slots
        self.remaining = np.zeros(slots, np.int64)
        # FIFO admission queue: deque, because slot refill pops from the
        # head every decode step — list.pop(0) is O(queue depth) and the
        # queue is exactly what grows under load.
        self.pending: Deque[Request] = collections.deque()
        self.tokens = np.zeros(slots, np.int32)
        self.stats = {"decoded_tokens": 0, "steps": 0, "wall": 0.0}

    def submit(self, req: Request):
        req.out = []
        self.pending.append(req)

    def _fill_slots(self):
        for i in range(self.slots):
            if self.active[i] is None and self.pending:
                req = self.pending.popleft()
                self.active[i] = req
                # Feed prompt tokens one-by-one through decode (prefill-by-
                # decode keeps one function; long-prompt serving uses
                # tfm.prefill instead and writes the cache in one shot).
                for tok in req.prompt[:-1]:
                    toks = self.tokens.copy()
                    toks[i] = int(tok)
                    _, self.cache = self._decode(
                        self.params, self.cache, torch.from_numpy(toks))
                self.tokens[i] = int(req.prompt[-1])
                self.remaining[i] = req.max_new_tokens

    def step(self) -> bool:
        """One decode step across all slots. Returns False when idle."""
        self._fill_slots()
        if all(r is None for r in self.active):
            return False
        t0 = time.perf_counter()
        logits, self.cache = self._decode(
            self.params, self.cache, torch.from_numpy(self.tokens))
        # Greedy: torch.argmax, like jnp.argmax, takes the first of tied
        # maxima (bfloat16 logits tie often across a 151936-entry vocab).
        nxt = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        self.stats["wall"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        for i in range(self.slots):
            req = self.active[i]
            if req is None:
                continue
            req.out.append(int(nxt[i]))
            self.tokens[i] = nxt[i]
            self.remaining[i] -= 1
            self.stats["decoded_tokens"] += 1
            if self.remaining[i] <= 0 or nxt[i] == self.eos_id:
                self.active[i] = None
        return True

    def run_to_completion(self) -> Dict:
        while self.step():
            pass
        return self.stats
