"""GIN (Graph Isomorphism Network, Xu et al. 2019) in the segment-sum regime.

Counterpart of ``repro/models/gin.py``.  Message passing is
``agg[v] = sum_{(u,v) in E} mask[e] * h[u]``: the reference takes the
source rows (``jnp.take``) and scatters them into their destinations
(``jax.ops.segment_sum``).  That is the embedding bag's function,
``out[b] = sum_{seg[j]=b} w[j] * working[inv[j]]``, with ``working`` the
node states, ``inv`` the edge sources, ``seg`` the destinations and ``w``
the edge mask, so each layer's aggregation is one
``ops.embedding_bag_working`` call: on the card kernel 1 (and kernel 1b for
its backward), which adds each node's messages in ascending edge order
without building the (E, d) messages; on the CPU its plain version.  The
graph readout, ``segment_sum(h, graph_ids)``, is one more call with
``inv = arange(N)``.

Supports full-graph training (node classification), sampled minibatch
(seed-node loss over a fanout-sampled block, ``data.graph_sampler``) and
batched disjoint small graphs with graph readout (molecule regime).

Contract: every ``edge_src`` indexes a row of the node states (the
generators and the sampler guarantee it; the card path cannot check it
without a host sync).  An ``edge_dst`` outside [0, N), and a graph id
outside [0, num_graphs), falls in no node, as in the reference's segment
sum.  The bag is float32 only: ``dtype`` other than float32 and
``message_dtype`` other than None or float32 raise (ROADMAP.md queue B
item 12).  ``node_shard`` has no effect on one card, as the
transformer's shard hints.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import he_init, softmax_cross_entropy


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin"
    n_layers: int = 5
    d_in: int = 1433
    d_hidden: int = 64
    n_classes: int = 7
    train_eps: bool = True        # eps learnable; False freezes eps at its
                                  # init (GIN-0): the forward detaches it
    readout: str = "node"         # node | graph (segment readout over graph_id)
    dtype: Any = torch.float32
    node_shard: bool = True       # the reference's node-state sharding hint
    message_dtype: Any = None     # None = dtype
    # Exact rewrite: W1 commutes with the sum aggregator, so when the input
    # width exceeds d_hidden, project BEFORE message passing — the bags then
    # move d_hidden-wide rows instead of d_in-wide ones.
    pre_project: bool = False


def _check_dtypes(cfg: GINConfig) -> None:
    """Raise for the dtypes the bag does not take."""
    if cfg.dtype != torch.float32 or cfg.message_dtype not in (
            None, torch.float32):
        raise NotImplementedError(
            f"GIN with dtype={cfg.dtype} and message_dtype="
            f"{cfg.message_dtype}: the port's bag is float32 only "
            "(ROADMAP.md queue B item 12, GIN in bfloat16)")


def init_params(generator: torch.Generator, cfg: GINConfig,
                device="cuda") -> Dict[str, Any]:
    """The reference's parameter tree (``eps``, ``layers`` of ``w1``,
    ``b1``, ``w2``, ``b2``, and ``out``), He-normal weights drawn from
    ``generator`` on ``device``."""
    _check_dtypes(cfg)
    device = resolve_device(device)
    params: Dict[str, Any] = {
        "eps": torch.zeros((cfg.n_layers,), dtype=torch.float32,
                           device=device),
        "layers": []}
    d_prev = cfg.d_in
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "w1": he_init(generator, (d_prev, cfg.d_hidden), cfg.dtype,
                          device=device),
            "b1": torch.zeros((cfg.d_hidden,), dtype=cfg.dtype, device=device),
            "w2": he_init(generator, (cfg.d_hidden, cfg.d_hidden), cfg.dtype,
                          device=device),
            "b2": torch.zeros((cfg.d_hidden,), dtype=cfg.dtype, device=device),
        })
        d_prev = cfg.d_hidden
    params["out"] = he_init(generator, (cfg.d_hidden, cfg.n_classes),
                            cfg.dtype, device=device)
    return params


def _index(t: torch.Tensor) -> torch.Tensor:
    """An index stream as the bag takes it: int32, contiguous."""
    return t.to(torch.int32).contiguous()


def forward(params, x: torch.Tensor, edge_src: torch.Tensor,
            edge_dst: torch.Tensor, cfg: GINConfig,
            edge_mask: Optional[torch.Tensor] = None,
            graph_ids: Optional[torch.Tensor] = None,
            num_graphs: int = 0) -> torch.Tensor:
    """Logits: (N, n_classes), or (num_graphs, n_classes) under graph
    readout.  ``x`` (N, d_in), ``edge_src``/``edge_dst`` (E,),
    ``edge_mask`` (E,) weights (padding edges 0), ``graph_ids`` (N,)."""
    _check_dtypes(cfg)
    N = x.shape[0]
    h = x.to(cfg.dtype)
    src, dst = _index(edge_src), _index(edge_dst)
    mask = (None if edge_mask is None
            else edge_mask.to(torch.float32).contiguous())
    eps = params["eps"] if cfg.train_eps else params["eps"].detach()
    for i, lp in enumerate(params["layers"]):
        pre = cfg.pre_project and h.shape[-1] > lp["w1"].shape[-1]
        src_feat = h @ lp["w1"] if pre else h
        agg = ops.embedding_bag_working(src_feat.contiguous(), src, dst,
                                        mask, N)
        if pre:
            # W1((1+eps)h + sum_j h_j) == (1+eps)(h W1) + sum_j (h_j W1)
            z = torch.relu((1.0 + eps[i]) * src_feat + agg + lp["b1"])
        else:
            z = (1.0 + eps[i]) * h + agg
            z = torch.relu(z @ lp["w1"] + lp["b1"])
        h = torch.relu(z @ lp["w2"] + lp["b2"])
    if cfg.readout == "graph":
        if graph_ids is None or num_graphs <= 0:
            raise ValueError("graph readout needs graph_ids and num_graphs")
        nodes = torch.arange(N, dtype=torch.int32, device=h.device)
        pooled = ops.embedding_bag_working(h.contiguous(), nodes,
                                           _index(graph_ids), None,
                                           num_graphs)
        return pooled @ params["out"]
    return h @ params["out"]


def loss_fn(params, batch: Dict[str, torch.Tensor],
            cfg: GINConfig) -> torch.Tensor:
    """batch: x, edge_src, edge_dst, labels, optional edge_mask/node_mask
    (node_mask restricts the loss to seed/valid nodes), optional graph_ids."""
    if cfg.readout == "graph":
        logits = forward(
            params, batch["x"], batch["edge_src"], batch["edge_dst"], cfg,
            edge_mask=batch.get("edge_mask"),
            graph_ids=batch["graph_ids"], num_graphs=batch["labels"].shape[0])
        return torch.mean(softmax_cross_entropy(logits, batch["labels"]))
    logits = forward(params, batch["x"], batch["edge_src"], batch["edge_dst"],
                     cfg, edge_mask=batch.get("edge_mask"))
    ce = softmax_cross_entropy(logits, batch["labels"])
    mask = batch.get("node_mask")
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(ce * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(ce)


def dense_reference_forward(params, x: torch.Tensor, adj: torch.Tensor,
                            cfg: GINConfig) -> torch.Tensor:
    """Oracle using a dense (N, N) adjacency matrix (``adj[u, v]`` = edges
    u -> v) — tests only."""
    h = x.to(cfg.dtype)
    eps = params["eps"] if cfg.train_eps else params["eps"].detach()
    for i, lp in enumerate(params["layers"]):
        agg = adj.T.to(torch.float32) @ h.to(torch.float32)
        z = ((1.0 + eps[i]) * h.to(torch.float32) + agg).to(cfg.dtype)
        z = torch.relu(z @ lp["w1"] + lp["b1"])
        h = torch.relu(z @ lp["w2"] + lp["b2"])
    return h @ params["out"]
