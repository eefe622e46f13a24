#!/usr/bin/env python3
"""GIN at gin-tu's MODEL under k-step Adam, the port and the reference side
by side on the CPU: the per-step losses of 20 steps at the launcher's
settings (n_pod 2, two_phase, lr 1e-3 and 1e-4) with k 10 and k 20.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/gin_merge_divergence.py

The graph is ogb_products' shape cut to 3000 nodes (community_graph:
average degree 25, width 100, 47 classes), both pods on the whole graph.
Both packages draw their own initial weights.  The losses fall until the
first merge (step k), then both go to NaN two steps later: the merge's
shared second moment is the cause, not the port (ROADMAP.md §C).
"""

import dataclasses

import jax
import numpy as np

from repro import configs as jconfigs
from repro.core.kstep import KStepConfig as JKStepConfig
from repro.models import gin as JG
from repro.runtime import trainer as jtrainer
from repro_torch import configs
from repro_torch.core.kstep import KStepConfig
from repro_torch.data.synthetic import community_graph
from repro_torch.runtime.factory import build_trainer
from repro_torch.runtime.trainer import TrainerConfig


def main():
    g = community_graph(0, 3000, 25, 100, 47)
    batch = {k: np.stack([v] * 2) for k, v in (
        ("x", g.x), ("edge_src", g.edge_src), ("edge_dst", g.edge_dst),
        ("labels", g.labels))}
    cfg = dataclasses.replace(configs.get("gin-tu").model_cfg, d_in=100,
                              n_classes=47)
    jcfg = dataclasses.replace(jconfigs.get("gin-tu").model_cfg, d_in=100,
                               n_classes=47)
    for lr in (1e-3, 1e-4):
        for k in (10, 20):
            tr = build_trainer("gin-tu", TrainerConfig(n_pod=2, kstep=KStepConfig(
                lr=lr, k=k, merge="two_phase")), model_cfg=cfg, device="cpu")
            jtr = jtrainer.DenseTrainer(
                lambda p, b: JG.loss_fn(p, b, jcfg),
                JG.init_params(jax.random.key(0), jcfg),
                jtrainer.TrainerConfig(n_pod=2, kstep=JKStepConfig(
                    lr=lr, k=k, merge="two_phase")))
            for name, t in (("port", tr), ("reference", jtr)):
                losses = [float(t.train_step(batch, podded=True))
                          for _ in range(20)]
                print(f"lr {lr:g} k {k} {name}: " + " ".join(
                    f"{x:.3g}" for x in losses))


if __name__ == "__main__":
    main()
