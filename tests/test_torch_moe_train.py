"""The port's A10d training (the MoE archs: their FFN's backward, the
windowed and chunked attention's backward, ``DenseTrainer``) against the
reference, on the CPU, in float32 at the smoke widths.

Both sides start from one state: the reference's ``init_params`` (norms
redrawn around 1, ``test_torch_lm._state``), exported as numpy and loaded
through ``interop.lm_from_reference``; activations and tokens come from
numpy.  The reference differentiates with ``jax.grad``: its ``moe_ffn``
under ``jax.vmap`` of the per-group functions, its attention as XLA's vjp
of ``_sdpa_dense`` (S <= ``dense_attn_threshold``) or of
``_sdpa_qblocked``; the port runs autograd through ``models/moe.py`` and
``ops.flash_attention``'s plain version and its vjp.  At S 64 the smoke
configs' window 16 (mixtral) and chunk 16 (llama4, whose layer 3 is
global) all bind.

Tolerances (``test_torch_lm_train``'s, each with its reason there):
- gradients: ``GRAD``, rtol 1e-4, atol 2e-6; the loss within rtol 1e-5;
- ``DenseTrainer``: the per-step losses within ``TRAIN``, rtol 1e-4, atol
  1e-6, after 7 steps at lr 1e-4; the podded parameters and the optimizer
  state within ``TRAIN_MOE`` (the lossy payloads to their grid, as there).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import kstep as jk
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.runtime import trainer as jtrainer
from repro_torch import configs, tree_map
from repro_torch.core import kstep as tk
from repro_torch.interop import lm_from_reference
from repro_torch.kernels import ops
from repro_torch.launch import train as launch
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.runtime.factory import build_trainer
from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig
from test_torch_lm import _state
from test_torch_lm_train import (GRAD, LOSSY, SCHEDULES, TRAIN,
                                 _assert_state_close, _batch, _leaves_np,
                                 _port_like, _torch_leaves)

torch.set_num_threads(1)

ARCHS = ["mixtral-8x7b", "llama4-scout-17b-16e"]
MOE_KEYS = ("router", "we_gate", "we_up", "we_down", "ws_gate", "ws_up",
            "ws_down")
AUX = 0.01                 # the smoke configs' router_aux_coef
# The trainer's state: TRAIN with atol 1e-5, not 1e-6.  These archs'
# gradients carry more float32 noise than the dense smoke model's (max
# |port - reference| / max |g| over a leaf, loss_fn at S 64: up to 2.6e-6
# for mixtral and 5.2e-6 for llama4 against 1.4e-6 for qwen3; the
# embedding's largest), and k-step Adam's local step divides each
# gradient by sqrt(v_hat) of the last merge: for an embedding row seen
# since, |g| ~ 5e-2 over sqrt(v_hat) ~ 1.3e-4, a gain of ~400 on that
# noise at lr 1e-4.  A few embedding elements of mixtral so part by up to
# 8e-6 after 7 steps while every loss agrees within 2e-7.
TRAIN_MOE = dict(TRAIN, atol=1e-5)


def _cfgs(arch, **kw):
    """The arch's smoke config in float32, in both packages; the
    reference's attention knobs go to its config alone."""
    jcfg = dataclasses.replace(jconfigs.get(arch).smoke_cfg,
                               dtype=jnp.float32, **kw)
    tkw = {k: v for k, v in kw.items()
           if k not in ("dense_attn_threshold", "attn_block_q")}
    tcfg = dataclasses.replace(configs.get(arch).smoke_cfg,
                               dtype=torch.float32, **tkw)
    return jcfg, tcfg


def _moe_leaves(params, layer=0):
    """Layer ``layer``'s MoE leaves of a numpy state, as numpy."""
    return {k: np.asarray(v[layer]) for k, v in params["layers"].items()
            if k in MOE_KEYS}


# ------------------------------------------------------------ moe_ffn's vjp
@pytest.mark.parametrize("capacity_factor", [None, 0.5],
                         ids=["fits", "overflow"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradients_match_jax_grad(arch, capacity_factor):
    """``sum(y * gy) + 0.01 aux`` differentiated by autograd through
    ``moe.moe_ffn`` against ``jax.grad`` of the reference's, for x and
    every MoE leaf (router, we_*, and llama4's ws_*): 4 groups of 64 tokens,
    and at capacity_factor 0.5, where choices drop (a dropped choice's
    gradient is zero in both).  gy is what a mean over the T = 256 tokens
    gives y, N(0, 1) / T, as in ``loss_fn``.

    Top-1 (llama4) renormalises its weight to exactly 1, so its router's
    gradient is the aux loss's alone: checked against ``jax.grad`` of
    ``0.01 aux``.  The weight's path (gv / sum gv) is 0 only up to
    rounding, in both packages: at gy N(0, 1), not / T, it leaves ~2e-5
    of noise in the router's gradient in each (the reference 2.3e-5, the
    port 1.4e-5, each against its own aux-only gradient), which is why gy
    carries the mean's 1 / T."""
    kw = {} if capacity_factor is None else dict(
        capacity_factor=capacity_factor)
    jcfg, tcfg = _cfgs(arch, **kw)
    lp = _moe_leaves(_state(jcfg))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 64, jcfg.d_model)).astype(np.float32)
    gy = (rng.standard_normal(x.shape) / (4 * 64)).astype(np.float32)

    def jloss(x_, lp_, coef_y=1.0):
        y, aux = JM.moe_ffn(x_, lp_, jcfg)
        return coef_y * jnp.sum(y * gy) + AUX * aux

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                           jax.tree.map(jnp.asarray, lp))
    tx = torch.from_numpy(x).requires_grad_(True)
    tlp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
           for k, v in lp.items()}
    y, aux = TM.moe_ffn(tx, tlp, tcfg)
    (torch.sum(y * torch.from_numpy(gy)) + AUX * aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[0]), **GRAD)
    assert sorted(tlp) == sorted(want[1])
    for k in tlp:
        np.testing.assert_allclose(tlp[k].grad.numpy(),
                                   np.asarray(want[1][k]), **GRAD)
    assert all(torch.isfinite(t.grad).all() for t in tlp.values())
    if capacity_factor is not None:
        gsz, G = TM.groups(4 * 64, tcfg.moe_group_size)
        cap = TM.capacity(gsz, tcfg.n_experts, tcfg.top_k, capacity_factor)
        plan, _ = TM.route(tx.detach().reshape(G, gsz, -1),
                           tlp["router"].detach(), tcfg.n_experts,
                           tcfg.top_k, cap)
        assert (~plan.keep).any() and plan.keep.any()
    if tcfg.top_k == 1:
        # the router's gradient is the aux loss's alone, in both packages
        aux_only = jax.grad(lambda lp_: jloss(jnp.asarray(x), lp_, 0.0))(
            jax.tree.map(jnp.asarray, lp))["router"]
        r = {k: v.detach().requires_grad_(True) for k, v in tlp.items()}
        (AUX * TM.moe_ffn(tx.detach(), r, tcfg)[1]).backward()
        for got in (r["router"].grad, tlp["router"].grad):
            np.testing.assert_allclose(got.numpy(), np.asarray(aux_only),
                                       **GRAD)


def test_moe_dropped_choice_gets_no_gradient():
    """A token whose every choice drops (capacity_factor 0.25: 8 slots an
    expert for 64 tokens, top-2) leaves the combine with y = 0; without the
    aux term its x gradient is exactly zero in the port (its weight is
    multiplied by keep = 0 too), and every x gradient matches the
    reference's ``jax.grad``."""
    jcfg, tcfg = _cfgs("mixtral-8x7b", capacity_factor=0.25)
    lp = _moe_leaves(_state(jcfg))
    x = np.random.default_rng(12).standard_normal(
        (1, 64, jcfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
    y, _ = TM.moe_ffn(tx, tlp, tcfg)
    y.sum().backward()
    cap = TM.capacity(64, tcfg.n_experts, tcfg.top_k, 0.25)
    plan, _ = TM.route(tx.detach().reshape(1, 64, -1), tlp["router"],
                       tcfg.n_experts, tcfg.top_k, cap)
    kept = torch.zeros(64, dtype=torch.bool)
    kept[plan.t_flat[plan.keep[0]]] = True
    assert (~kept).any()
    assert torch.equal(y[0, ~kept], torch.zeros_like(y[0, ~kept]))
    want = jax.grad(lambda a: jnp.sum(JM.moe_ffn(a, jax.tree.map(
        jnp.asarray, lp), jcfg)[0]))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **GRAD)
    assert not tx.grad[0, ~kept].any()


# ------------------------------------------------------------------ loss_fn
@pytest.mark.parametrize("path,kw", [
    ("dense", {}),
    ("qblocked", dict(dense_attn_threshold=16, attn_block_q=16)),
])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_its_gradients_match_the_reference(arch, path, kw):
    """``loss_fn`` (the trunk under per-layer checkpoints, the chunked
    head and cross-entropy, ``router_aux_coef`` times the layers' aux) and
    every parameter's gradient, 2 x 64 tokens.  The reference on
    ``_sdpa_dense`` or, with ``dense_attn_threshold=16, attn_block_q=16``,
    on ``_sdpa_qblocked``; the port on ``ops.flash_attention`` either way,
    under each layer's window or chunk (its backward counted as the plain
    vjp's)."""
    jcfg, tcfg = _cfgs(arch, **kw)
    params = _state(jcfg)
    batch = _batch(jcfg.vocab, 2, 64)
    want, want_g = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg))(
        jax.tree.map(jnp.asarray, params))
    tparams = tree_map(lambda x: x.requires_grad_(True),
                       lm_from_reference(params, device="cpu"))
    ops.reset_launches()
    got = T.loss_fn(tparams, {k: torch.from_numpy(x)
                              for k, x in batch.items()}, tcfg)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # each layer's forward, its recompute, and one backward
    assert ops.launches["flash_attention_ref"] == 2 * tcfg.n_layers
    assert ops.launches["flash_attention_backward_ref"] == tcfg.n_layers
    grads = _torch_leaves(tree_map(lambda x: x.grad, tparams))
    want_leaves = _leaves_np(want_g)
    assert len(grads) == len(want_leaves)
    for a, b in zip(grads, want_leaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD)


# ------------------------------------------------------------ DenseTrainer
@pytest.mark.parametrize("merge,delay", SCHEDULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_trainer_matches_the_reference(arch, merge, delay):
    """n_pod 2, k 3, 7 steps (two merges, immediate or one boundary late)
    from the reference's state after one step, on batches of 4 x 64 tokens
    (2 sequences, 2 MoE groups a pod): the per-step losses, the podded
    parameters and m, v_local, v_hat (and the int8 residual); under a
    lossy payload step by step from the reference's state."""
    jcfg, tcfg = _cfgs(arch)
    kw = dict(lr=1e-4, k=3, merge=merge)
    jtr = jtrainer.DenseTrainer(
        lambda p, b: JT.loss_fn(p, b, jcfg),
        jax.tree.map(jnp.asarray, _state(jcfg)),
        jtrainer.TrainerConfig(n_pod=2, kstep=jk.KStepConfig(**kw),
                               merge_delay=delay))
    cfg = TrainerConfig(n_pod=2, kstep=tk.KStepConfig(**kw),
                        merge_delay=delay)

    def loss(p, b):
        return T.loss_fn(p, b, tcfg)

    batches = [_batch(jcfg.vocab, 4, 64, seed=s) for s in range(8)]
    jtr.train_step(batches[0])       # pods apart: one step of their own
    ttr = _port_like(jtr, loss, cfg)
    for b in batches[1:]:
        if merge in LOSSY:
            ttr = _port_like(jtr, loss, cfg)
        want = float(jtr.train_step(b))
        got = ttr.train_step(b)
        assert got.dim() == 0
        np.testing.assert_allclose(float(got), want, **TRAIN)
        if merge in LOSSY:
            _assert_state_close(ttr, jtr, merge, TRAIN_MOE)
    assert int(ttr.opt_state.step) == 8
    _assert_state_close(ttr, jtr, merge, TRAIN_MOE)


# ------------------------------------------------------ the entry points
@pytest.mark.parametrize("arch", ARCHS)
def test_build_trainer_trains_the_arch(arch):
    """``build_trainer`` gives a ``DenseTrainer`` over ``loss_fn`` whose
    steps take finite losses that come down, with each layer's attention
    under its window or chunk (forward, recompute and the plain vjp
    counted) and every CUDA counter at 0 on the CPU."""
    tcfg = configs.get(arch).smoke_cfg
    tr = build_trainer(arch, TrainerConfig(
        n_pod=2, kstep=tk.KStepConfig(lr=1e-3, k=2)), device="cpu")
    assert isinstance(tr, DenseTrainer)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab, (4, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ops.reset_launches()
    losses = [float(tr.train_step(batch)) for _ in range(4)]
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    n = 4 * 2 * tcfg.n_layers
    assert ops.launches["flash_attention_ref"] == 2 * n
    assert ops.launches["flash_attention_backward_ref"] == n
    assert not any(v for k, v in ops.launches.items()
                   if not k.endswith("_ref"))
    assert int(tr.opt_state.step) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_arch_on_the_cpu(arch, capsys):
    """``--arch <arch> --device cpu``: 50 steps (one logging boundary) of
    the smoke config at the launcher's n_pod 2 (batches of 8 x 64 tokens,
    4 sequences a pod, 4 MoE groups of 64), the reference's final line
    with a finite loss that has come down from the start (ln 512 =
    6.24)."""
    launch.main(["--arch", arch, "--steps", "50", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    words = line.split()
    assert words[:2] == ["final", "loss"] and line.endswith("steps/s)")
    assert math.isfinite(float(words[2])) and float(words[2]) < 6.0
