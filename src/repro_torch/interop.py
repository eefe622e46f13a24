"""Load a state exported from the JAX reference into the port.

JAX's random bits cannot be replayed in PyTorch, so a comparison of the two
starts both from one state: the reference trainer's parameters, exported as
numpy (``jax.device_get`` of ``tr.dense``, ``tr.tables``,
``tr.sparse_state.accum`` and, for training, ``tr.opt_state``), go through
``from_reference`` and into ``HybridTrainer(..., state=...)``.  This module
reads numpy only.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree_map
from repro_torch.core.kstep import KStepAdamState


class ReferenceState(NamedTuple):
    dense: Any                      # podded dense tree (leading n_pod dim)
    tables: Dict[str, torch.Tensor]
    accum: Dict[str, torch.Tensor]
    opt_state: Optional[KStepAdamState] = None   # None: a fresh k-step state


def from_reference(dense_np, tables_np, accum_np, opt_state_np=None,
                   device="cuda") -> ReferenceState:
    """The reference trainer's numpy state as tensors on ``device``.

    ``opt_state_np`` is the reference's ``KStepAdamState`` after
    ``jax.device_get`` (or a dict with its fields ``step``, ``m``,
    ``v_local``, ``v_hat``, ``ef``; ``ef`` is None unless the merge is
    ``int8_ef``)."""
    device = resolve_device(device)

    def conv(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    opt_state = None
    if opt_state_np is not None:
        fields = (opt_state_np._asdict() if hasattr(opt_state_np, "_asdict")
                  else dict(opt_state_np))
        opt_state = KStepAdamState(
            step=torch.tensor(int(np.asarray(fields["step"])),
                              dtype=torch.int32, device=device),
            m=tree_map(conv, fields["m"]),
            v_local=tree_map(conv, fields["v_local"]),
            v_hat=tree_map(conv, fields["v_hat"]),
            ef=(None if fields.get("ef") is None
                else tree_map(conv, fields["ef"])),
        )
    return ReferenceState(
        dense=tree_map(conv, dense_np),
        tables={n: conv(t) for n, t in tables_np.items()},
        accum={n: conv(a) for n, a in accum_np.items()},
        opt_state=opt_state,
    )
