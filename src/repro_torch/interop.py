"""Load a state exported from the JAX reference into the port.

JAX's random bits cannot be replayed in PyTorch, so a comparison of the two
starts both from one state: the reference trainer's parameters, exported as
numpy (``jax.device_get`` of ``tr.dense``, ``tr.tables``,
``tr.sparse_state.accum``, for training ``tr.opt_state`` and, under the
cached placement, ``tr.backend_state``), go through ``from_reference`` and
into ``HybridTrainer(..., state=...)``.  Under the DiskStore,
``from_reference`` writes the full tables and accumulators into the
store's pages, so both packages start from one state on disk.  The LM's
parameter tree goes through ``lm_from_reference`` (GIN's too: the same
keys and layouts) and its KV cache through
``lm_cache_from_reference`` (``lm_cache_to_reference`` is the inverse, for
comparisons); a reference ``DenseTrainer``'s podded parameters and k-step
Adam state through ``dense_trainer_from_reference``.  This module reads
numpy only.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree_map
from repro_torch.core.cache_tier import CacheState
from repro_torch.core.kstep import KStepAdamState


class ReferenceState(NamedTuple):
    dense: Any                      # podded dense tree (leading n_pod dim)
    tables: Dict[str, torch.Tensor]
    accum: Dict[str, torch.Tensor]
    opt_state: Optional[KStepAdamState] = None   # None: a fresh k-step state
    backend_state: Optional[Dict[str, Any]] = None  # None: a fresh one


def _fields(x) -> dict:
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def from_reference(dense_np, tables_np, accum_np, opt_state_np=None,
                   device="cuda", backend_state_np=None, store=None,
                   capacity=None) -> ReferenceState:
    """The reference trainer's numpy state as tensors on ``device``.

    ``opt_state_np`` is the reference's ``KStepAdamState`` after
    ``jax.device_get`` (or a dict with its fields ``step``, ``m``,
    ``v_local``, ``v_hat``, ``ef``; ``ef`` is None unless the merge is
    ``int8_ef``).  ``backend_state_np`` is the reference's per-table
    backend state after ``jax.device_get``: under the cached placement
    ``{table: CacheState}`` (or dicts with its fields), so a comparison can
    start from a warm cache; the cache state goes to ``device``.  The
    trainer moves the tables where its placement keeps them.

    ``store``: a ``DiskStore`` (the trainer's engine's), into whose pages
    the full ``tables_np`` and ``accum_np`` go; the returned tables and
    accumulators are then the engine's ``(capacity, dim)`` staging buffers
    (``capacity``: the engine's, required with ``store``)."""
    device = resolve_device(device)
    if (store is None) != (capacity is None):
        raise ValueError("pass store and capacity together (the DiskStore "
                         "and its engine's pull capacity)")

    def conv(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    backend_state = None
    if backend_state_np is not None:
        backend_state = {
            n: CacheState(**{f: conv(v) for f, v in _fields(s).items()})
            for n, s in backend_state_np.items()}
    opt_state = None
    if opt_state_np is not None:
        fields = _fields(opt_state_np)
        opt_state = KStepAdamState(
            step=torch.tensor(int(np.asarray(fields["step"])),
                              dtype=torch.int32, device=device),
            m=tree_map(conv, fields["m"]),
            v_local=tree_map(conv, fields["v_local"]),
            v_hat=tree_map(conv, fields["v_hat"]),
            ef=(None if fields.get("ef") is None
                else tree_map(conv, fields["ef"])),
        )
    if store is None:
        tables = {n: conv(t) for n, t in tables_np.items()}
        accum = {n: conv(a) for n, a in accum_np.items()}
    else:
        tables, accum = {}, {}
        for n in sorted(tables_np):
            t, a = np.asarray(tables_np[n]), np.asarray(accum_np[n])
            store.create_table(n, t.shape[0], t.shape[1], t.dtype,
                               init_rows_fn=lambda lo, hi, _t=t: _t[lo:hi],
                               init_accum_fn=lambda lo, hi, _a=a: _a[lo:hi])
            tables[n] = torch.zeros((capacity, t.shape[1]),
                                    dtype=torch.from_numpy(t[:0]).dtype,
                                    device=device)
            accum[n] = torch.zeros((capacity, t.shape[1]),
                                   dtype=torch.float32, device=device)
    return ReferenceState(
        dense=tree_map(conv, dense_np),
        tables=tables,
        accum=accum,
        opt_state=opt_state,
        backend_state=backend_state,
    )


def _leaf_from_numpy(x, device) -> torch.Tensor:
    """One exported leaf as a tensor on ``device``.  bfloat16 leaves come as
    ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses: their
    bits travel as uint16 and are viewed as bfloat16."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(x).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def lm_from_reference(params_np, device="cuda"):
    """The reference LM's parameter tree (``repro.models.transformer``,
    numpy after ``jax.device_get``) as the port's tree on ``device``: the
    same keys and layouts, every leaf bit for bit.  GIN's tree
    (``repro.models.gin``: ``eps``, ``layers`` of ``w1``, ``b1``, ``w2``,
    ``b2``, and ``out``) loads the same way."""
    device = resolve_device(device)
    return tree_map(lambda x: _leaf_from_numpy(x, device), params_np)


def lm_cache_from_reference(cache_np, device="cuda"):
    """The reference's KV cache (``init_cache`` / ``decode_step``'s dict,
    numpy after ``jax.device_get``) as the port's on ``device``: ``k`` and
    ``v`` from the reference's (L, B, Skv, Kv, hd) into the port's
    (L, B, Kv, Skv, hd), contiguous, every element bit for bit; ``pos``
    (Skv,) and ``t`` (0-dim) int32."""
    device = resolve_device(device)
    out = {n: _leaf_from_numpy(np.asarray(cache_np[n]), "cpu")
           .transpose(2, 3).contiguous().to(device) for n in ("k", "v")}
    for n in ("pos", "t"):
        out[n] = torch.from_numpy(
            np.array(cache_np[n], dtype=np.int32, copy=True)).to(device)
    return out


def lm_cache_to_reference(cache) -> Dict[str, np.ndarray]:
    """The port's KV cache in the reference's layout, as numpy: ``k`` and
    ``v`` (L, B, Skv, Kv, hd) in float32 (a bfloat16 cache widened, which
    is exact), ``pos`` and ``t`` int32."""
    out = {n: cache[n].detach().transpose(2, 3).to("cpu", torch.float32)
           .contiguous().numpy() for n in ("k", "v")}
    for n in ("pos", "t"):
        out[n] = cache[n].detach().cpu().numpy().astype(np.int32)
    return out


def dense_trainer_from_reference(params_np, opt_state_np, loss_fn, cfg,
                                 device="cuda"):
    """A port ``DenseTrainer`` in the state of a reference one: its podded
    parameters (``jax.device_get(tr.params)``, every leaf with the leading
    pod dimension; bfloat16 leaves bit for bit) and its ``KStepAdamState``
    (``jax.device_get(tr.opt_state)``, or a dict of its fields ``step``,
    ``m``, ``v_local``, ``v_hat``, ``ef``), on ``device``.  ``loss_fn`` and
    ``cfg`` (a ``runtime.trainer.TrainerConfig``) as for ``DenseTrainer``;
    the trainer's step count is the state's."""
    from repro_torch.runtime.trainer import DenseTrainer

    device = resolve_device(device)
    conv = lambda x: _leaf_from_numpy(x, device)      # noqa: E731
    fields = _fields(opt_state_np)
    opt_state = KStepAdamState(
        step=torch.tensor(int(np.asarray(fields["step"])), dtype=torch.int32,
                          device=device),
        m=tree_map(conv, fields["m"]),
        v_local=tree_map(conv, fields["v_local"]),
        v_hat=tree_map(conv, fields["v_hat"]),
        ef=(None if fields.get("ef") is None
            else tree_map(conv, fields["ef"])))
    return DenseTrainer(loss_fn, tree_map(conv, params_np), cfg,
                        opt_state=opt_state, podded=True, device=device)
