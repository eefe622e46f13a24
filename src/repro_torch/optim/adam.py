"""Reference dense optimizers (single replica): the non-k-step baselines the
paper compares against, and the oracles for the k-step tests (k=1, N=1
must match ``Adam``).

Counterpart of ``repro/optim/adam.py``, with its arithmetic and order.
Like the reference's, ``step_fn`` is functional: it returns new
parameters and a new state and leaves its inputs as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree_map

Tree = Any


class AdamState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Tree                 # float32
    v: Tree                 # float32


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam matching Algorithm 2 at N=1 (no bias correction, v0 = eps)."""

    lr: float = 1e-3
    b1: float = 0.0
    b2: float = 0.999
    eps: float = 1e-8
    bias_correction: bool = False

    def init(self, params: Tree) -> AdamState:
        device = _first_leaf(params).device
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), params),
            v=tree_map(lambda x: torch.full(x.shape, self.eps,
                                            dtype=torch.float32,
                                            device=x.device), params),
        )

    @torch.no_grad()
    def step_fn(self, params: Tree, grads: Tree, state: AdamState):
        t = state.step + 1
        m = _map(lambda mm, g: self.b1 * mm
                 + (1 - self.b1) * g.to(torch.float32), state.m, grads)
        v = _map(lambda vv, g: self.b2 * vv
                 + (1 - self.b2) * torch.square(g.to(torch.float32)),
                 state.v, grads)
        if self.bias_correction:
            tf = t.to(torch.float32)
            ms = 1.0 / (1 - self.b1 ** tf) if self.b1 > 0 else 1.0
            vs = 1.0 / (1 - self.b2 ** tf)
        else:
            ms = vs = 1.0
        new_p = _map(lambda p, mm, vv: (
            p.to(torch.float32) - self.lr * (mm * ms) / torch.sqrt(vv * vs)
        ).to(p.dtype), params, m, v)
        return new_p, AdamState(step=t, m=m, v=v)


class AdagradState(NamedTuple):
    accum: Tree             # float32


@dataclasses.dataclass(frozen=True)
class Adagrad:
    lr: float = 0.05
    eps: float = 1e-10
    initial_accumulator: float = 0.1

    def init(self, params: Tree) -> AdagradState:
        return AdagradState(accum=tree_map(
            lambda x: torch.full(x.shape, self.initial_accumulator,
                                 dtype=torch.float32, device=x.device),
            params))

    @torch.no_grad()
    def step_fn(self, params: Tree, grads: Tree, state: AdagradState):
        accum = _map(lambda a, g: a + torch.square(g.to(torch.float32)),
                     state.accum, grads)
        new_p = _map(lambda p, g, a: (
            p.to(torch.float32)
            - self.lr * g.to(torch.float32) / (torch.sqrt(a) + self.eps)
        ).to(p.dtype), params, grads, accum)
        return new_p, AdagradState(accum=accum)


def _first_leaf(tree):
    out = []
    tree_map(out.append, tree)
    return out[0]


def _map(fn, tree, *rest):
    """``fn`` over the matching leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)
