"""Cross-pod merge schedules of the k-step merge payload, on one device.

Counterpart of ``repro/core/merge.py``.  Every schedule computes the mean
over the leading pod dimension of each leaf and broadcasts it back.  On
the TPU mesh the schedules differ in the route the bytes take (one flat
all-reduce, or the two-phase reduce-scatter / all-reduce / all-gather of
paper §3.2); on one card the pods are a tensor dimension and every route is
the same pod-dim mean.  What still differs is the payload: ``bf16`` casts
the lossy payload to bfloat16, ``int8_ef`` quantizes it to int8 with error
feedback and sums in int8.  ``pmean_mean`` (the ``shard_map`` pod axis) has
no counterpart here.

Trees are dicts, lists and tuples of tensors; the functions return new
trees.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree_map

Tree = Any


def _pod_mean_keep(x: torch.Tensor) -> torch.Tensor:
    """The f32 mean over the pod dimension, broadcast back (sum, then
    divide by n_pod, as ``jnp.mean``)."""
    mu = torch.sum(x.to(torch.float32), dim=0, keepdim=True) / x.shape[0]
    return mu.expand(x.shape)


def flat_mean(tree: Tree) -> Tree:
    return tree_map(lambda x: _pod_mean_keep(x).to(x.dtype), tree)


def two_phase_mean(tree: Tree, payload_dtype=None) -> Tree:
    """The two-phase schedule's arithmetic: the payload (cast to
    ``payload_dtype`` when given) averaged in f32, cast back to the payload
    dtype, then to the leaf's dtype."""

    def leaf(x):
        flat = x.reshape(x.shape[0], -1)
        if payload_dtype is not None:
            flat = flat.to(payload_dtype)
        mu = _pod_mean_keep(flat).to(flat.dtype)
        return mu.reshape(x.shape).to(x.dtype)

    return tree_map(leaf, tree)


def spec_aware_mean(tree: Tree, specs: Optional[Tree] = None,
                    payload_dtype=None) -> Tree:
    """The reference's sharding-aware two-phase mean; with every leaf on one
    device the sharding specs change no arithmetic, and ``specs`` must be
    None."""
    if specs is not None:
        raise NotImplementedError(
            "spec_aware_mean: sharded leaves need a multi-GPU mesh, which "
            "the port does not have yet (ROADMAP.md queue A8)")
    return two_phase_mean(tree, payload_dtype)


def int8_ef_mean(tree: Tree, ef: Tree):
    """int8-quantized mean with error feedback.

    Each pod contributes ``q_i = round((x_i + ef_i) / (s * n_pod))`` with a
    shared scale ``s = max_i |x_i + ef_i| / 127``; the pod sum runs in int8
    (wrapping, as the reference's int8 reduction does), and
    ``merged = sum_i q_i * s``.  The new residual is what each pod failed to
    send.  Returns ``(merged_tree_f32, new_ef_tree)``.
    """
    def leaf(x, r):
        n_pod = x.shape[0]
        p = x.to(torch.float32) + r
        flat = p.reshape(n_pod, -1)
        s = torch.max(torch.abs(flat)) / 127.0 + 1e-30
        step = s * n_pod
        q = torch.clamp(torch.round(flat / step), -127, 127).to(torch.int8)
        qs = torch.sum(q, dim=0, keepdim=True, dtype=torch.int8)
        m = qs.to(torch.float32) * s * 1.0
        m = m.expand(flat.shape).reshape(x.shape)
        resid = (flat - q.to(torch.float32) * step).reshape(x.shape)
        return m, resid

    return _unzip_map(leaf, tree, ef)


def _unzip_map(fn, a: Tree, b: Tree):
    """``fn(x, y) -> (u, v)`` over the matching leaves of two trees of one
    structure; returns the tree of ``u`` and the tree of ``v``."""
    if isinstance(a, dict):
        parts = {k: _unzip_map(fn, a[k], b[k]) for k in a}
        return ({k: p[0] for k, p in parts.items()},
                {k: p[1] for k, p in parts.items()})
    if isinstance(a, (list, tuple)):
        parts = [_unzip_map(fn, x, y) for x, y in zip(a, b)]
        return (type(a)(p[0] for p in parts), type(a)(p[1] for p in parts))
    return fn(a, b)


def make_merge_fn(name: str):
    """Return ``mean_fn(tree, allow_lossy=True)`` for the named schedule.

    ``allow_lossy=False`` callers (the v-merge) always get a lossless
    route."""
    if name == "flat":
        return lambda tree, allow_lossy=True: flat_mean(tree)
    if name in ("two_phase", "int8_ef"):
        # int8_ef: the x payload goes through int8_ef_mean inside KStepAdam;
        # v and the other lossless payloads ride the two-phase route
        return lambda tree, allow_lossy=True: spec_aware_mean(tree)
    if name == "bf16":
        return lambda tree, allow_lossy=True: spec_aware_mean(
            tree, payload_dtype=torch.bfloat16 if allow_lossy else None)
    raise ValueError(f"unknown merge schedule: {name!r}")
