"""k-step Adam model merging: Algorithm 2 of Zhao et al. (2022).

Counterpart of ``repro/core/kstep.py``.  Each of the N workers ("pods")
runs *local* Adam steps; every k steps all workers average their
parameters AND their second-moment estimates, then continue from the
merged point.  Between merges the denominator uses a *frozen shared* second
moment ``v_hat`` (the paper's ``v_t = v_{t-1}`` branch), while each worker
keeps its local EMA ``v_local`` running; at a merge round
``v_hat <- mean_i v_local_i`` and ``x <- mean_i (x_i - lr * m_i / sqrt(v_hat))``
(lines 11-13).

Representation ("podded" trees): every dense parameter and optimizer moment
carries a leading pod dimension ``(n_pod, *shape)``; on one card the pods
are that tensor dimension and a merge is a pod-dim mean
(``repro_torch.core.merge``).

``KStepAdam.step`` updates the parameters and the optimizer state in place
(the port's counterpart of the reference's buffer donation) and returns the
same objects.  The delayed-merge methods come with ``DenseTrainer``
(ROADMAP.md queue A10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree_map
from repro_torch.core import merge as merge_lib

Tree = Any


@dataclasses.dataclass(frozen=True)
class KStepConfig:
    """Hyper-parameters of k-step Adam (paper defaults where stated)."""

    lr: float = 1e-3
    b1: float = 0.0          # paper §5: beta_1 = 0.0 for the dense tower
    b2: float = 0.999        # paper §5: beta_2 = 0.999
    eps: float = 1e-8        # Algorithm 2 line 2: v_0 = eps * 1
    k: int = 1               # merge every k local steps (k=1 == synchronous Adam)
    weight_decay: float = 0.0
    bias_correction: bool = False  # Algorithm 2 has none (v_0 = eps handles t=0)
    merge_v: bool = True     # paper: "the second moment ... is also averaged"
    merge: str = "flat"      # flat | two_phase | int8_ef | bf16
    grad_clip: float = 0.0   # global-norm clip (0 = off)
    # As in the reference: before the FIRST merge the local steps use the
    # running local EMA instead of the frozen v_hat (= eps), which from a
    # cold start would multiply early updates by 1/sqrt(eps).  Identical to
    # Algorithm 2 from the first merge onward.
    local_v_warmup: bool = True


class KStepAdamState(NamedTuple):
    step: torch.Tensor      # () int32, number of completed local steps
    m: Tree                 # podded first moment  (n_pod, *shape) f32
    v_local: Tree           # podded local second-moment EMA (n_pod, *shape) f32
    v_hat: Tree             # podded *shared* denominator, frozen between merges
    ef: Optional[Tree]      # error-feedback residual (int8_ef merge only)


def pod_replicate(tree: Tree, n_pod: int) -> Tree:
    """Stack identical replicas along a new leading pod dimension (new
    contiguous tensors)."""
    return tree_map(
        lambda x: x[None].expand((n_pod,) + tuple(x.shape)).clone(
            memory_format=torch.contiguous_format), tree)


def pod_slice(tree: Tree, i: int = 0) -> Tree:
    """One pod's replica (views, no copy)."""
    return tree_map(lambda x: x[i], tree)


def pod_consensus_error(tree: Tree) -> torch.Tensor:
    """sum_i ||x_i - mean(x)||^2, the quantity bounded by Eq. (10)."""
    def leaf(x):
        mu = torch.sum(x, dim=0, keepdim=True) / x.shape[0]
        return torch.sum((x - mu) ** 2)
    return sum(leaves(tree_map(leaf, tree)))


def leaves(tree: Tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in insertion order."""
    out: list = []
    tree_map(out.append, tree)
    return out


class KStepAdam:
    """k-step Adam over podded parameter trees, in place.

    Parameters
    ----------
    cfg: KStepConfig
    n_pod: number of local workers.
    lr_schedule: optional callable ``step -> lr`` (``step`` a 0-dim int32
        tensor) overriding ``cfg.lr``.
    """

    def __init__(self, cfg: KStepConfig, n_pod: int,
                 lr_schedule: Optional[Callable[[torch.Tensor], Any]] = None):
        self.cfg = cfg
        self.n_pod = int(n_pod)
        self.lr_schedule = lr_schedule
        self._mean = merge_lib.make_merge_fn(cfg.merge)

    # ------------------------------------------------------------------ init
    def init(self, params_podded: Tree) -> KStepAdamState:
        f32 = lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                    device=x.device)
        eps = lambda x: torch.full(x.shape, self.cfg.eps, dtype=torch.float32,
                                   device=x.device)
        device = leaves(params_podded)[0].device
        return KStepAdamState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_map(f32, params_podded),
            v_local=tree_map(eps, params_podded),
            v_hat=tree_map(eps, params_podded),
            ef=(tree_map(f32, params_podded) if self.cfg.merge == "int8_ef"
                else None),
        )

    # ------------------------------------------------------------- one step
    @torch.no_grad()
    def step(self, params: Tree, grads: Tree, state: KStepAdamState,
             merge: Optional[bool] = None):
        """Apply one local Adam step, and merge across pods when due, in
        place; returns ``(params, state)`` (the same objects).

        ``merge=None`` decides from the step count (``(step + 1) % k == 0``,
        read on the host); the trainer passes the decision explicitly, from
        its host-side step counter.
        """
        cfg = self.cfg
        t = state.step + 1
        if merge is None:
            merge = int(t) % cfg.k == 0
        lr = self.lr_schedule(t) if self.lr_schedule else cfg.lr
        P = leaves(params)
        G = [g.detach() for g in leaves(grads)]
        M, VL, VH = leaves(state.m), leaves(state.v_local), leaves(state.v_hat)

        if cfg.grad_clip > 0.0:
            # per-pod global-norm clip (each replica clips its own gradient)
            def pod_sq(g):
                g32 = g.to(torch.float32)
                return torch.sum(g32 * g32, dim=tuple(range(1, g.dim())))
            norms = torch.sqrt(sum(pod_sq(g) for g in G))
            scale = torch.clamp_max(cfg.grad_clip / (norms + 1e-12), 1.0)
            G = [(g.to(torch.float32)
                  * scale.reshape((self.n_pod,) + (1,) * (g.dim() - 1))
                  ).to(g.dtype) for g in G]

        # moment updates (Algorithm 2 lines 5-6), always local
        m_new = [cfg.b1 * mm + (1.0 - cfg.b1) * g.to(torch.float32)
                 for mm, g in zip(M, G)]
        vl_new = [cfg.b2 * vv + (1.0 - cfg.b2) * torch.square(
            g.to(torch.float32)) for vv, g in zip(VL, G)]

        if cfg.bias_correction:
            tf = t.to(torch.float32)
            mhat_s = (1.0 / (1.0 - cfg.b1 ** tf)) if cfg.b1 > 0 else 1.0
            vhat_s = 1.0 / (1.0 - cfg.b2 ** tf)
        else:
            mhat_s = 1.0
            vhat_s = 1.0

        def adam_delta(mm, vh, p):
            d = lr * (mm * mhat_s) / torch.sqrt(vh * vhat_s)
            if cfg.weight_decay > 0.0:
                d = d + lr * cfg.weight_decay * p.to(torch.float32)
            return d

        new_vh = new_ef = None
        if not merge:
            if cfg.local_v_warmup:
                pre_first_merge = t <= cfg.k
                v_use = [torch.where(pre_first_merge, vl, vh)
                         for vh, vl in zip(VH, vl_new)]
            else:
                v_use = VH
            new_p = [(p.to(torch.float32) - adam_delta(mm, vu, p)).to(p.dtype)
                     for p, mm, vu in zip(P, m_new, v_use)]
        else:
            # v_hat <- mean_i v_local (line 12); the v payload rides the
            # merge schedule but is never lossy (positivity must hold)
            new_vh = (self._mean(vl_new, allow_lossy=False) if cfg.merge_v
                      else VH)
            # x_i - lr * m_i / sqrt(v_hat_new), then the pod average (line 13)
            local_x = [p.to(torch.float32) - adam_delta(mm, vh, p)
                       for p, mm, vh in zip(P, m_new, new_vh)]
            if cfg.merge == "int8_ef":
                merged, new_ef = merge_lib.int8_ef_mean(local_x,
                                                        leaves(state.ef))
            else:
                merged = self._mean(local_x, allow_lossy=True)
            new_p = [mx.to(p.dtype) for p, mx in zip(P, merged)]

        for dst, src in zip(P, new_p):
            dst.copy_(src)
        for dst, src in zip(M, m_new):
            dst.copy_(src)
        for dst, src in zip(VL, vl_new):
            dst.copy_(src)
        if new_vh is not None and cfg.merge_v:
            for dst, src in zip(VH, new_vh):
                dst.copy_(src)
        if new_ef is not None:
            for dst, src in zip(leaves(state.ef), new_ef):
                dst.copy_(src)
        state.step.copy_(t)
        return params, state
