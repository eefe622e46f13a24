#!/usr/bin/env python3
"""Bytes that autograd keeps for one GIN forward at gin-tu's MODEL, counted
on the CPU at a reduced node count and scaled to ogb_products.

    PYTHONPATH=src python3 tools/gin_saved_bytes.py [--nodes N]

One pod's ``gin.loss_fn`` on a ``community_graph`` of N nodes (average
degree 25, width 100, 47 classes: ogb_products' shape cut to N), under
``torch.autograd.graph.saved_tensors_hooks``: each saved tensor's storage
counted once, and split into what scales with the nodes or edges and what
does not (the inputs x and the edges are the caller's, counted apart).
Scaled by 2,449,029 / N and by the 2 pods of the launcher's settings.
"""

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.data.synthetic import community_graph
from repro_torch.models import gin as G

OGB_NODES = 2_449_029


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=24_490)
    args = ap.parse_args()
    cfg = dataclasses.replace(configs.get("gin-tu").model_cfg, d_in=100,
                              n_classes=47)
    g = community_graph(0, args.nodes, 25, 100, 47)
    batch = {"x": torch.from_numpy(g.x),
             "edge_src": torch.from_numpy(g.edge_src),
             "edge_dst": torch.from_numpy(g.edge_dst),
             "labels": torch.from_numpy(g.labels)}
    params = G.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    for leaf in [params["eps"], params["out"]] + [
            t for layer in params["layers"] for t in layer.values()]:
        leaf.requires_grad_(True)
    inputs = {t.untyped_storage().data_ptr() for t in batch.values()}
    seen, total = set(), [0]

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in seen and ptr not in inputs:
            seen.add(ptr)
            total[0] += t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        G.loss_fn(params, batch, cfg)
    scale = OGB_NODES / args.nodes
    print(f"{args.nodes} nodes, {g.edge_src.size} edges: autograd keeps "
          f"{total[0]} bytes beyond the inputs ({total[0] / args.nodes:.1f} "
          f"a node); at ogb_products' {OGB_NODES} nodes "
          f"{total[0] * scale / 1e9:.2f} GB a pod, "
          f"{2 * total[0] * scale / 1e9:.2f} GB for 2 pods")


if __name__ == "__main__":
    main()
