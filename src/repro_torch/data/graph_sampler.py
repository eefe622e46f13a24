"""Fanout neighbor sampler for sampled-minibatch GNN training (GraphSAGE
style), required by the ``minibatch_lg`` shape.

A copy of ``repro/data/graph_sampler.py`` (host-side numpy): it builds a
CSR adjacency once, then yields fixed-size (padded) relabeled subgraphs so
the device step has static shapes.  From the same ``np.random.Generator``
its blocks equal the reference's element for element.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class NeighborSampler:
    def __init__(self, n_nodes: int, edge_src: np.ndarray, edge_dst: np.ndarray):
        self.n_nodes = n_nodes
        # CSR over incoming edges: for a seed (dst) we sample its in-neighbors
        # (message sources).
        order = np.argsort(edge_dst, kind="stable")
        self.src_sorted = edge_src[order]
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        counts = np.bincount(edge_dst, minlength=n_nodes)
        self.indptr[1:] = np.cumsum(counts)

    def _sample_neighbors(self, rng, nodes: np.ndarray, fanout: int):
        starts = self.indptr[nodes]
        degs = self.indptr[nodes + 1] - starts
        # with-replacement sampling keeps everything vectorized
        offs = (rng.random((len(nodes), fanout)) * np.maximum(degs, 1)[:, None]).astype(np.int64)
        nbrs = self.src_sorted[starts[:, None] + offs]
        valid = (degs > 0)[:, None] & np.ones((1, fanout), bool)
        return nbrs, valid

    def sample_block(
        self, rng: np.random.Generator, seeds: np.ndarray, fanouts: Sequence[int],
    ) -> Dict[str, np.ndarray]:
        """Layered fanout sample. Returns a relabeled padded subgraph:
        nodes (n_max,), edge_src/edge_dst (e_max,) LOCAL indices,
        edge_mask, seed_mask over nodes.  n_max/e_max are the deterministic
        worst-case sizes for (len(seeds), fanouts) — static device shapes.
        The padded edges are (0, 0) with mask 0."""
        n_seeds = len(seeds)
        frontier = np.unique(seeds)
        seen = [frontier]
        all_src, all_dst, all_keep = [], [], []
        for f in fanouts:
            nbrs, valid = self._sample_neighbors(rng, frontier, f)
            src = nbrs.reshape(-1)
            dst = np.repeat(frontier, f)
            keep = valid.reshape(-1)
            all_src.append(np.where(keep, src, dst))  # self-loop for invalid
            all_dst.append(dst)
            all_keep.append(keep)
            # next layer expands only the NEW neighbors (bounds worst case)
            frontier = np.unique(src[keep])
            seen.append(frontier)

        # global -> local relabel over the union of all layers
        sub_nodes = np.unique(np.concatenate(seen))
        n_max = self.worst_case_nodes(n_seeds, fanouts)
        e_max = self.worst_case_edges(n_seeds, fanouts)
        src_cat = np.concatenate(all_src)
        dst_cat = np.concatenate(all_dst)
        mask_cat = np.concatenate(all_keep)
        loc_src = np.searchsorted(sub_nodes, src_cat).astype(np.int32)
        loc_dst = np.searchsorted(sub_nodes, dst_cat).astype(np.int32)

        def pad(a, n, fill=0):
            out = np.full((n,), fill, a.dtype)
            out[: len(a)] = a
            return out

        nodes_pad = pad(sub_nodes.astype(np.int32), n_max)
        node_valid = pad(np.ones(len(sub_nodes), np.float32), n_max)
        seed_local = np.searchsorted(sub_nodes, np.unique(seeds)).astype(np.int32)
        seed_mask = np.zeros(n_max, np.float32)
        seed_mask[seed_local] = 1.0
        return {
            "nodes": nodes_pad,                        # global ids (for features)
            "node_valid": node_valid,
            "edge_src": pad(loc_src, e_max),
            "edge_dst": pad(loc_dst, e_max),
            "edge_mask": pad(mask_cat.astype(np.float32), e_max),
            "seed_mask": seed_mask,
            "n_real_nodes": np.int32(len(sub_nodes)),
        }

    @staticmethod
    def worst_case_nodes(n_seeds: int, fanouts: Sequence[int]) -> int:
        n, total = n_seeds, n_seeds
        for f in fanouts:
            n = n * f
            total += n
        return total

    @staticmethod
    def worst_case_edges(n_seeds: int, fanouts: Sequence[int]) -> int:
        n, total = n_seeds, 0
        for f in fanouts:
            total += n * f
            n = n * f
        return total
