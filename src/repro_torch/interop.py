"""Load a state exported from the JAX reference into the port.

JAX's random bits cannot be replayed in PyTorch, so a comparison of the two
starts both from one state: the reference trainer's parameters, exported as
numpy (``jax.device_get`` of ``tr.dense``, ``tr.tables`` and
``tr.sparse_state.accum``), go through ``from_reference`` and into
``HybridTrainer(..., state=...)``.  This module reads numpy only.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device, tree_map


class ReferenceState(NamedTuple):
    dense: Any                      # podded dense tree (leading n_pod dim)
    tables: Dict[str, torch.Tensor]
    accum: Dict[str, torch.Tensor]


def from_reference(dense_np, tables_np, accum_np,
                   device="cuda") -> ReferenceState:
    """The reference trainer's numpy state as tensors on ``device``."""
    device = resolve_device(device)

    def conv(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    return ReferenceState(
        dense=tree_map(conv, dense_np),
        tables={n: conv(t) for n, t in tables_np.items()},
        accum={n: conv(a) for n, a in accum_np.items()},
    )
