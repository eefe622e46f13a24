"""The port's LM training (A10c) against the reference, on the CPU.

Both sides start from one state: the reference's ``init_params`` (norms
redrawn around 1 with numpy, so they matter), exported as numpy and loaded
into the port; tokens from numpy.  The reference's training attention is
XLA's vjp of ``_sdpa_dense`` (S <= ``dense_attn_threshold``) or of
``_sdpa_qblocked``; the port's is ``ops.flash_attention``'s plain version
on the CPU and its vjp.  Everything runs in float32 at a small width.

Tolerances, each with its reason:
- cross-entropy and its gradient: rtol 1e-5, atol 1e-6 (float32, the
  gradient as ``exp(logits - logz)`` where the reference differentiates
  ``exp(shifted) / sum``: a few ulps apart);
- ``loss_fn``: the loss within rtol 1e-5, every gradient within rtol 1e-4,
  atol 2e-6 (products of width 64 and the softmax's vjp summed in other
  orders; a gradient element near 0 is a difference of such sums);
- ``Adam``, ``Adagrad``: rtol 1e-6, atol 1e-7 (the same float32 ops, XLA
  fusing some into fused multiply-adds);
- ``DenseTrainer`` against the reference's: losses, parameters and the
  optimizer state within rtol 1e-4, atol 1e-6 after 7 steps at lr 1e-4
  (the gradients' float32 differences above, a few 1e-7, carried through
  Adam's division by sqrt(v), which near v = eps multiplies them by
  lr / sqrt(eps)).  At the launcher's lr 1e-3 this narrow model's loss
  doubles within 7 steps under ``merge_delay`` 1, in the reference too,
  and the two trajectories then part by far more than that noise.
  The lossy payloads (``bf16``, ``int8_ef``) round each merged element
  to a grid: an element within float32 noise of a rounding boundary may
  take the neighbouring grid point on one side, one grid step away (a
  bfloat16 ulp; an int8 step, max |x + ef| / 127 times n_pod), and the
  trajectories then part as after any other perturbation.  So there the
  port is started from the reference's state before every step, and up
  to one element in a thousand may differ by at most 1.5 grid steps, the
  rest within the tolerance above;
- k=1, N=1 ``DenseTrainer`` against ``Adam``, and the sliced merge against
  the whole-leaf one: bit for bit (the same float32 ops in the same order).
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
from repro.data import synthetic as jsyn
from repro.models import common as JC
from repro.models import transformer as JT
from repro.optim import adam as jadam
from repro.runtime import trainer as jtrainer
from repro_torch import configs, tree_map
from repro_torch.core import kstep as tk
from repro_torch.data import synthetic as tsyn
from repro_torch.interop import dense_trainer_from_reference, lm_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as launch
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.optim import adam as tadam
from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig

torch.set_num_threads(1)

# a narrow qwen3 (qk-norm, GQA) so that the reference's jits stay quick
NARROW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=96, head_dim=16)
CE = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=2e-6)
TRAIN = dict(rtol=1e-4, atol=1e-6)


def _cfgs(**kw):
    """The qwen3-14b smoke config, narrowed, in float32, in both packages."""
    jcfg = dataclasses.replace(jconfigs.get("qwen3-14b").smoke_cfg,
                               dtype=jnp.float32, **NARROW, **kw)
    tkw = {k: v for k, v in kw.items()
           if k not in ("dense_attn_threshold", "attn_block_q",
                        "attn_block_kv")}
    tcfg = dataclasses.replace(configs.get("qwen3-14b").smoke_cfg,
                               dtype=torch.float32, **NARROW, **tkw)
    return jcfg, tcfg


def _state(jcfg, seed=0):
    """The reference's init as numpy, the norms redrawn around 1."""
    params = jax.device_get(JT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    for k in ("attn_norm", "ffn_norm", "q_norm", "k_norm"):
        layers[k] = (1.0 + 0.1 * rng.standard_normal(layers[k].shape)
                     ).astype(np.float32)
    return dict(params, layers=layers)


def _batch(vocab, B, S, seed=0):
    rng = np.random.default_rng(seed + 7)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _torch_leaves(tree):
    """A port tree's leaves in the reference's (sorted-key) order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _torch_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _torch_leaves(v)]
    return [tree.detach().float().numpy()]


# ----------------------------------------------------------- cross-entropy
@pytest.mark.parametrize("shape", [(37, 50), (2, 9, 130)])
def test_softmax_cross_entropy_and_its_gradient_match_the_reference(shape):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal(shape) * 4).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    w = rng.standard_normal(shape[:-1]).astype(np.float32)

    def jloss(x):
        return jnp.sum(JC.softmax_cross_entropy(x, jnp.asarray(labels)) * w)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    per_token = C.softmax_cross_entropy(x, torch.from_numpy(labels))
    np.testing.assert_allclose(
        per_token.detach().numpy(),
        np.asarray(JC.softmax_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(labels))), **CE)
    got = torch.sum(per_token * torch.from_numpy(w))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **CE)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), **CE)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_lookup_scatter_adds_in_the_table_dtype(dtype):
    """The lookup's gradient against the reference's ``_embed_lookup_bwd``
    (a scatter-add into a zero table in the table's dtype): float32
    within 1e-6; bfloat16 in bfloat16 and within one bf16 rounding of each
    summand (repeated ids add in another order)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(2)
    table = rng.standard_normal((13, 8)).astype(np.float32)
    ids = rng.integers(0, 13, (3, 11)).astype(np.int32)
    g = rng.standard_normal((3, 11, 8)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(
        JC.sharded_embed_lookup(t, jnp.asarray(ids)).astype(jnp.float32)
        * g))(jnp.asarray(table, jdt))
    t = torch.from_numpy(table).to(tdt).requires_grad_(True)
    out = C.embed_lookup(t, torch.from_numpy(ids))
    assert out.shape == (3, 11, 8)
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert t.grad.dtype == tdt
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(
        rtol=2e-2, atol=3e-2)
    np.testing.assert_allclose(t.grad.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_flash_attention_plain_vjp_matches_the_reference_attention():
    """``ref.flash_attention_backward_ref`` (the plain version of kernel
    9b) and ``ops.flash_attention``'s CPU backward against XLA's vjp of the
    reference's ``_sdpa_dense``, GQA, causal, float32: within rtol 1e-5,
    atol 1e-6.  ``flash_attention_lse_ref`` against the log-sum-exp of
    the same scores."""
    jcfg, _ = _cfgs()
    B, S, H, Kv, hd = 2, 19, 4, 2, 16
    rng = np.random.default_rng(3)
    q, k, v, g = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd), (B, S, H, hd))]
    pos = jnp.arange(S, dtype=jnp.int32)
    _, vjp = jax.vjp(lambda a, b, c: JT._sdpa_dense(jcfg, 0, a, b, c, pos,
                                                    pos), *map(jnp.asarray,
                                                               (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk_, tv, tg = map(torch.from_numpy, (q, k, v, g))
    got = tref.flash_attention_backward_ref(tq, tk_, tv, tg, True)
    xs = [x.clone().requires_grad_(True) for x in (tq, tk_, tv)]
    ops.reset_launches()
    ops.flash_attention(*xs, causal=True).backward(tg)
    assert ops.launches["flash_attention_backward_ref"] == 1
    for a, b, w in zip(got, xs, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(a, b.grad)
    s = np.einsum("bskgd,btkd->bkgst", q.reshape(B, S, Kv, H // Kv, hd), k)
    s = s / math.sqrt(hd) + np.where(np.tril(np.ones((S, S))), 0.0, -1e30)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(
        tref.flash_attention_lse_ref(tq, tk_, True).numpy(),
        lse.reshape(B, H, S), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ loss_fn
@pytest.mark.parametrize("path,S,kw", [
    ("dense", 32, {}),
    ("dense, 8 cross-entropy chunks", 32, dict(ce_chunk_tokens=8)),
    ("qblocked", 64, dict(dense_attn_threshold=16, attn_block_q=16)),
])
def test_loss_fn_and_its_gradients_match_the_reference(path, S, kw):
    """The reference on ``_sdpa_dense`` (S <= 1024) or, with
    ``dense_attn_threshold=16, attn_block_q=16`` at S 64, on
    ``_sdpa_qblocked``; the port on ``ops.flash_attention`` either way."""
    jcfg, tcfg = _cfgs(**kw)
    params = _state(jcfg)
    batch = _batch(jcfg.vocab, 2, S)
    want, want_g = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg))(
        jax.tree.map(jnp.asarray, params))
    tparams = tree_map(lambda x: x.requires_grad_(True),
                       lm_from_reference(params, device="cpu"))
    got = T.loss_fn(tparams, {k: torch.from_numpy(x)
                              for k, x in batch.items()}, tcfg)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    grads = _torch_leaves(tree_map(lambda x: x.grad, tparams))
    for a, b in zip(grads, _leaves_np(want_g)):
        np.testing.assert_allclose(a, b, **GRAD)


# --------------------------------------------------------------- optimizers
@pytest.mark.parametrize("bias_correction,b1", [(False, 0.0), (True, 0.9)])
def test_adam_matches_the_reference(bias_correction, b1):
    rng = np.random.default_rng(4)
    shapes = {"w": (5, 3), "b": [(3,), (2, 2)]}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    jopt = jadam.Adam(lr=1e-2, b1=b1, bias_correction=bias_correction)
    topt = tadam.Adam(lr=1e-2, b1=b1, bias_correction=bias_correction)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jopt.init(jp)
    tp = tree_map(torch.from_numpy, params)
    ts = topt.init(tp)
    for _ in range(4):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), params)
        jp, js = jopt.step_fn(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = topt.step_fn(tp, tree_map(torch.from_numpy, g), ts)
    assert int(ts.step) == int(js.step) == 4
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(_torch_leaves(got), _leaves_np(want)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_adagrad_matches_the_reference():
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((4, 6)).astype(np.float32)}
    jopt, topt = jadam.Adagrad(lr=0.05), tadam.Adagrad(lr=0.05)
    jp = jax.tree.map(jnp.asarray, params)
    js, tp = jopt.init(jp), tree_map(torch.from_numpy, params)
    ts = topt.init(tp)
    for _ in range(4):
        g = {"w": rng.standard_normal((4, 6)).astype(np.float32)}
        jp, js = jopt.step_fn(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = topt.step_fn(tp, tree_map(torch.from_numpy, g), ts)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts.accum["w"].numpy(),
                               np.asarray(js.accum["w"]), rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------------------ DenseTrainer
def _lm_loss(tcfg):
    return lambda p, b: T.loss_fn(p, b, tcfg)


def test_k1_n1_dense_trainer_equals_adam():
    """k=1, N=1 k-step Adam is Adam: every step is a merge over one pod,
    and the parameters come out bit for bit as ``optim.Adam``'s on the
    same gradients."""
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    params = lm_from_reference(_state(jcfg), device="cpu")
    tr = DenseTrainer(_lm_loss(tcfg), params, TrainerConfig(
        n_pod=1, kstep=tk.KStepConfig(lr=1e-2, k=1)), device="cpu")
    adam = tadam.Adam(lr=1e-2)
    p = tree_map(torch.clone, params)
    state = adam.init(p)
    for step in range(3):
        batch = _batch(tcfg.vocab, 2, 16, seed=step)
        staged = {k: torch.from_numpy(x) for k, x in batch.items()}
        leaf_p = tree_map(lambda x: x.detach().requires_grad_(True), p)
        T.loss_fn(leaf_p, staged, tcfg).backward()
        p, state = adam.step_fn(p, tree_map(lambda x: x.grad, leaf_p), state)
        tr.train_step(batch)
    for a, b in zip(tk.leaves(tr.params), tk.leaves(p)):
        assert torch.equal(a[0], b)


SCHEDULES = [(m, 0) for m in ("flat", "two_phase", "int8_ef", "bf16")] + [
    (m, 1) for m in ("flat", "two_phase", "bf16")]
LOSSY = ("bf16", "int8_ef")


def _port_like(jtr, loss_fn, cfg):
    """A port ``DenseTrainer`` in the reference trainer's state (with its
    queue of delayed merges)."""
    ttr = dense_trainer_from_reference(
        jax.device_get(jtr.params), jax.device_get(jtr.opt_state), loss_fn,
        cfg, device="cpu")
    for snap, merged in jtr._pending_merges:
        ttr._pending_merges.append(tuple(
            lm_from_reference(jax.device_get(t), device="cpu")
            for t in (snap, merged)))
    return ttr


def _grid_step(merge, want, param):
    """One step of the lossy payload's grid at ``want``'s elements (a leaf
    of the parameters or of the int8 residual; ``param`` the parameter
    leaf, whose scale sets the int8 grid)."""
    if merge == "int8_ef":
        return np.full(want.shape, 2 * np.abs(param).max() / 127.0)
    return np.abs(want) * 2.0 ** -7          # a bfloat16 ulp, at most


def _assert_state_close(ttr, jtr, merge, tol=TRAIN):
    js, ts = jtr.opt_state, ttr.opt_state
    assert int(ts.step) == int(js.step) == ttr.step_num == jtr.step_num
    # (port, reference, rounded to the payload's grid)
    pairs = [(ttr.params, jtr.params, True), (ts.m, js.m, False),
             (ts.v_local, js.v_local, False), (ts.v_hat, js.v_hat, False)]
    if merge == "int8_ef":
        pairs.append((ts.ef, js.ef, True))
    off_grid = total = 0
    params = _leaves_np(jtr.params)
    for got, want, gridded in pairs:
        for a, b, p in zip(_torch_leaves(got), _leaves_np(want), params):
            if merge in LOSSY and gridded:
                off = np.abs(a - b) > tol["atol"] + tol["rtol"] * np.abs(b)
                assert np.all(np.abs(a - b)[off]
                              <= 1.5 * _grid_step(merge, b, p)[off])
                off_grid += int(off.sum())
                total += off.size
            else:
                np.testing.assert_allclose(a, b, **tol)
    assert off_grid <= total // 1000


@pytest.mark.parametrize("merge,delay", SCHEDULES)
def test_dense_trainer_matches_the_reference(merge, delay):
    """n_pod 2, k 3, 7 steps (two merges, immediate or one boundary late)
    from the reference's state after one step: the per-step losses, the
    podded parameters and m, v_local, v_hat (and the int8 residual);
    under a lossy payload step by step from the reference's state."""
    jcfg, tcfg = _cfgs()
    kw = dict(lr=1e-4, k=3, merge=merge)
    jtr = jtrainer.DenseTrainer(
        lambda p, b: JT.loss_fn(p, b, jcfg),
        jax.tree.map(jnp.asarray, _state(jcfg)),
        jtrainer.TrainerConfig(n_pod=2, kstep=jk.KStepConfig(**kw),
                               merge_delay=delay))
    cfg = TrainerConfig(n_pod=2, kstep=tk.KStepConfig(**kw),
                        merge_delay=delay)
    batches = [_batch(jcfg.vocab, 4, 16, seed=s) for s in range(8)]
    jtr.train_step(batches[0])       # pods apart: one step of their own
    ttr = _port_like(jtr, _lm_loss(tcfg), cfg)
    for b in batches[1:]:
        if merge in LOSSY:
            ttr = _port_like(jtr, _lm_loss(tcfg), cfg)
        want = float(jtr.train_step(b))
        got = ttr.train_step(b)
        assert got.dim() == 0
        np.testing.assert_allclose(float(got), want, **TRAIN)
        if merge in LOSSY:
            _assert_state_close(ttr, jtr, merge)
    assert int(ttr.opt_state.step) == 8
    _assert_state_close(ttr, jtr, merge)


@pytest.mark.parametrize("knob,match", [
    (dict(prefetch=True), "sparse-path feature"),
    (dict(fused_kernels=True), "sparse-path feature"),
    (dict(store="disk", spill_dir="/nonexistent"), "no tables to spill"),
    (dict(page_rows=64), "no tables to spill"),
    (dict(merge_delay=1, kstep=tk.KStepConfig(merge="int8_ef")),
     "error-feedback"),
    (dict(merge_quorum=0.5), "merge_quorum"),
    (dict(merge_delay=-1), "merge_delay"),
])
def test_dense_trainer_rejects_what_the_reference_rejects(knob, match):
    _, tcfg = _cfgs()
    params = T.init_params(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    with pytest.raises((ValueError, NotImplementedError), match=match):
        DenseTrainer(_lm_loss(tcfg), params, TrainerConfig(**knob),
                     device="cpu")
    jknob = dict(knob)
    if "kstep" in jknob:
        jknob["kstep"] = jk.KStepConfig(merge="int8_ef")
    jparams = JT.init_params(jax.random.PRNGKey(0), _cfgs()[0])
    with pytest.raises((ValueError, NotImplementedError), match=match):
        jtrainer.DenseTrainer(lambda p, b: 0.0, jparams,
                              jtrainer.TrainerConfig(**jknob))


def test_dense_trainer_checkpoints_raise_naming_a3(tmp_path):
    """Checkpoints (A3), which raised until ported: ``ckpt_dir`` gives the
    trainer a manager that saves every ``ckpt_every`` steps, and a fresh
    trainer resumes the LM's parameters and moments bit for bit."""
    _, tcfg = _cfgs()
    params = T.init_params(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    cfg = TrainerConfig(n_pod=2, kstep=tk.KStepConfig(lr=1e-4, k=2),
                        ckpt_dir=str(tmp_path), ckpt_every=2)
    tr = DenseTrainer(_lm_loss(tcfg), params, cfg, device="cpu")
    for s in range(3):
        tr.train_step(_batch(tcfg.vocab, 4, 16, seed=s))
    tr.ckpt.wait()
    tr2 = DenseTrainer(_lm_loss(tcfg), params, cfg, device="cpu")
    assert tr2.resume() and tr2.step_num == 2
    tr2.train_step(_batch(tcfg.vocab, 4, 16, seed=2))
    for a, b in zip(tk.leaves(tr2.params) + tk.leaves(tr2.opt_state.m),
                    tk.leaves(tr.params) + tk.leaves(tr.opt_state.m)):
        assert torch.equal(a, b)


def test_dense_trainer_gradients_land_in_their_buffer():
    """Each pod's gradient is autograd's gradient of its own loss, in its
    slice of one podded buffer that keeps its storage across steps."""
    jcfg, tcfg = _cfgs()
    tr = DenseTrainer(_lm_loss(tcfg), lm_from_reference(_state(jcfg),
                                                        device="cpu"),
                      TrainerConfig(n_pod=2, kstep=tk.KStepConfig(k=2)),
                      device="cpu")
    ptrs = [g.data_ptr() for g in tk.leaves(tr.grads)]
    for step in range(3):
        batch = _batch(tcfg.vocab, 4, 16, seed=step)
        before = tree_map(torch.clone, tr.params)
        tr.train_step(batch)
        for pod in range(2):
            p = tree_map(lambda x: x[pod].detach().requires_grad_(True),
                         before)
            T.loss_fn(p, {k: torch.from_numpy(x[2 * pod:2 * pod + 2])
                          for k, x in batch.items()}, tcfg).backward()
            for a, b in zip(tk.leaves(tr.grads), tk.leaves(p)):
                torch.testing.assert_close(a[pod], b.grad, rtol=1e-6,
                                           atol=1e-7)
    assert [g.data_ptr() for g in tk.leaves(tr.grads)] == ptrs


# --------------------------------------------------------- the sliced merge
@pytest.mark.parametrize("n_pod", [2, 3])
@pytest.mark.parametrize("merge", ["flat", "two_phase", "bf16", "int8_ef"])
def test_sliced_merge_equals_the_whole_leaf_merge(merge, n_pod, monkeypatch):
    """A merge step with ``MERGE_SLAB`` cut to 50 elements (every leaf but
    the smallest in slices; ``int8_ef`` stays whole-leaf) gives the same
    bits as with the whole leaf at once, in float32 and bfloat16 leaves,
    with bias correction and weight decay."""
    rng = np.random.default_rng(6)
    shapes = {"big": (n_pod, 7, 33), "mid": (n_pod, 61), "small": (n_pod, 3)}
    runs = []
    for slab in (1 << 26, 50):
        monkeypatch.setattr(tk, "MERGE_SLAB", slab)
        r = np.random.default_rng(6)
        for dtype in (torch.float32, torch.bfloat16):
            p = {k: torch.from_numpy(r.standard_normal(s).astype(np.float32))
                 .to(dtype) for k, s in shapes.items()}
            opt = tk.KStepAdam(tk.KStepConfig(lr=1e-2, k=2, merge=merge,
                                              bias_correction=True, b1=0.9,
                                              weight_decay=1e-3), n_pod)
            st = opt.init(p)
            for step in range(4):
                g = {k: torch.from_numpy(r.standard_normal(s).astype(
                    np.float32)).to(dtype) for k, s in shapes.items()}
                opt.step(p, g, st, merge=step % 2 == 1)
            runs.append([p, st.m, st.v_local, st.v_hat, st.ef])
    assert rng is not None
    whole, sliced = runs[:2], runs[2:]
    for a, b in zip(whole, sliced):
        for ta, tb in zip(a, b):
            if ta is None:
                assert tb is None
                continue
            for x, y in zip(tk.leaves(ta), tk.leaves(tb)):
                assert torch.equal(x, y)


def test_merge_slabs_cut_only_the_large_leaves(monkeypatch):
    monkeypatch.setattr(tk, "MERGE_SLAB", 100)
    opt = tk.KStepAdam(tk.KStepConfig(merge="two_phase"), 2)
    assert opt._slabs(torch.zeros(2, 50)) == [None]
    assert opt._slabs(torch.zeros(2, 7, 33)) == [(0, 50), (50, 100),
                                                 (100, 150), (150, 200),
                                                 (200, 231)]
    opt = tk.KStepAdam(tk.KStepConfig(merge="int8_ef"), 2)
    assert opt._slabs(torch.zeros(2, 7, 33)) == [None]


# ------------------------------------------------------------ data, launcher
def test_lm_batches_equal_the_reference_token_for_token():
    want = jsyn.lm_batches(seed=3, batch=5, seq_len=17, vocab=151936,
                           worker=1)
    got = tsyn.lm_batches(seed=3, batch=5, seq_len=17, vocab=151936,
                          worker=1)
    for _ in range(3):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_launcher_trains_qwen3_14b_on_the_cpu(capsys):
    """``--arch qwen3-14b --device cpu``: 50 steps (one logging boundary)
    of the smoke config, the reference's final line with a finite loss
    that has come down from the start (ln 512 = 6.24)."""
    launch.main(["--arch", "qwen3-14b", "--steps", "50", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    words = line.split()
    assert words[:2] == ["final", "loss"] and line.endswith("steps/s)")
    assert math.isfinite(float(words[2])) and float(words[2]) < 6.0
    with pytest.raises(ValueError, match="--rows"):
        launch.main(["--arch", "qwen3-14b", "--steps", "1", "--device",
                     "cpu", "--rows", "10"])
