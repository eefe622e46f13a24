"""gin-tu [GNN] — 5 layers, d_hidden=64, sum aggregator, learnable eps.
[arXiv:1810.00826; paper]

The same numbers as ``repro/configs/gin_tu.py``.  Four shape regimes:
Cora-size full batch, Reddit-scale sampled minibatch (fanouts 15/10 through
``data.graph_sampler``), ogbn-products full batch, and batched small
molecule graphs with graph readout.
"""

from typing import Dict

from repro_torch.configs import ArchSpec, ShapeSpec
from repro_torch.models.gin import GINConfig

MODEL = GINConfig(
    name="gin-tu", n_layers=5, d_hidden=64, d_in=1433, n_classes=7,
    train_eps=True,
)

SMOKE = GINConfig(
    name="gin-tu-smoke", n_layers=3, d_hidden=16, d_in=8, n_classes=3,
    train_eps=True,
)

SHAPES: Dict[str, ShapeSpec] = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7},
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train",
        {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
         "fanout0": 15, "fanout1": 10, "d_feat": 602, "n_classes": 41},
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "train",
        {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100, "n_classes": 47},
    ),
    "molecule": ShapeSpec(
        "molecule", "train",
        {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16, "n_classes": 2},
    ),
}

ARCH = ArchSpec(
    name="gin-tu", family="gnn", model_cfg=MODEL, smoke_cfg=SMOKE,
    shapes=SHAPES, source="arXiv:1810.00826; paper",
)
