"""The port's k-step Adam, merges and compression against the reference.

The same podded trees and gradients, made with numpy from a seed, go
through ``repro.core.kstep.KStepAdam`` (one CPU device, no mesh: every
merge schedule is a pod-dim mean there too) and ``repro_torch.core.kstep``,
step after step, in local and merge steps; every step compares the
parameters and the whole optimizer state.

Tolerances, and why:
  - rtol = 1e-5, atol = 1e-7 for every schedule.  XLA contracts
    ``b2*v + c*g^2`` into fused multiply-adds and fuses the Adam update;
    PyTorch rounds each op, so the two differ by a few f32 ulps per step.
    The ``bf16`` and ``int8_ef`` payloads round the same values on both
    sides on these inputs (a value that fell within those few ulps of a
    bfloat16 or int8 rounding boundary could round to its neighbour; none
    does here).
  - the int8 error-feedback residual: atol = 1e-6.  It is the difference
    of two nearly equal numbers (the payload, |x| < 2, and its int8
    rounding), so the payload's few-ulp difference shows as an absolute
    error of that size.
  - ``compression``: the int8 codes are exact (division and max are exact
    in both); the residual within rtol = 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import kstep as jk
from repro.core import merge as jmerge
from repro_torch.core import compression as tcomp
from repro_torch.core import kstep as tk
from repro_torch.core import merge as tmerge

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-7)
RESIDUAL = dict(rtol=1e-5, atol=1e-6)
N_POD = 3


def _tree(rng, n_pod=N_POD):
    """A podded tree shaped like a small dense tower."""
    shapes = {"wq": (4, 4), "mlp": [{"w": (8, 5), "b": (5,)},
                                    {"w": (5, 1), "b": (1,)}]}

    def draw(s):
        return (rng.standard_normal((n_pod,) + s) * 0.3).astype(np.float32)

    return jax.tree.map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, copy=True)),
                        tree)


def _close(got, want, **tol):
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), got)),
                    jax.tree.leaves(jax.device_get(want))):
        np.testing.assert_allclose(g, np.asarray(w), **tol)


CASES = {
    "flat k1": dict(merge="flat", k=1),
    "flat k3": dict(merge="flat", k=3),
    "two_phase k3": dict(merge="two_phase", k=3),
    "two_phase k3 no warmup": dict(merge="two_phase", k=3,
                                   local_v_warmup=False, eps=1e-4),
    "bf16 k3": dict(merge="bf16", k=3),
    "int8_ef k3": dict(merge="int8_ef", k=3),
    "int8_ef k1": dict(merge="int8_ef", k=1),
    "clip + bias correction k3": dict(merge="flat", k=3, grad_clip=0.5,
                                      bias_correction=True, b1=0.9),
    "weight decay, no v merge k3": dict(merge="two_phase", k=3,
                                        weight_decay=0.01, merge_v=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kstep_adam_matches_reference(case):
    kw = dict(lr=1e-2, **CASES[case])
    rng = np.random.default_rng(sorted(CASES).index(case))
    params = _tree(rng)
    jopt = jk.KStepAdam(jk.KStepConfig(**kw), N_POD)
    topt = tk.KStepAdam(tk.KStepConfig(**kw), N_POD)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _to_torch(params)
    ts = topt.init(tp)
    for step in range(1, 8):
        grads = _tree(rng)
        merge = step % kw["k"] == 0
        jp, js = jopt.step(jp, jax.tree.map(jnp.asarray, grads), js,
                           merge=merge)
        out_p, out_s = topt.step(tp, _to_torch(grads), ts, merge=merge)
        assert out_p is tp and out_s is ts                 # in place
        assert int(ts.step) == int(js.step) == step
        _close(tp, jp, **F32)
        for f in ("m", "v_local", "v_hat"):
            _close(getattr(ts, f), getattr(js, f), **F32)
        if kw["merge"] == "int8_ef":
            _close(ts.ef, js.ef, **RESIDUAL)
        else:
            assert ts.ef is None and js.ef is None


def test_step_decides_merge_from_the_count_and_takes_a_schedule():
    """merge=None merges every k-th step; lr_schedule receives the step."""
    kw = dict(merge="flat", k=2)
    rng = np.random.default_rng(5)
    params = _tree(rng)
    sched_j = lambda t: 1e-2 / (1.0 + t)
    jopt = jk.KStepAdam(jk.KStepConfig(**kw), N_POD, lr_schedule=sched_j)
    topt = tk.KStepAdam(tk.KStepConfig(**kw), N_POD, lr_schedule=sched_j)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _to_torch(params)
    ts = topt.init(tp)
    for step in range(1, 5):
        grads = _tree(rng)
        jp, js = jopt.step(jp, jax.tree.map(jnp.asarray, grads), js)
        topt.step(tp, _to_torch(grads), ts)
        _close(tp, jp, **F32)
        spread = float(tk.pod_consensus_error(tp))
        np.testing.assert_allclose(spread, float(jk.pod_consensus_error(jp)),
                                   rtol=1e-5, atol=1e-10)
        assert (spread < 1e-10) == (step % 2 == 0)   # merged pods agree


@pytest.mark.parametrize("name", ["flat", "two_phase", "bf16", "int8_ef"])
@pytest.mark.parametrize("allow_lossy", [True, False])
def test_merge_fns_match_reference(name, allow_lossy):
    tree = _tree(np.random.default_rng(6))
    got = tmerge.make_merge_fn(name)(_to_torch(tree), allow_lossy=allow_lossy)
    want = jmerge.make_merge_fn(name)(jax.tree.map(jnp.asarray, tree),
                                      allow_lossy=allow_lossy)
    if name == "bf16" and allow_lossy:     # the payload went through bf16
        for leaf in jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), got)):
            as_bf16 = torch.from_numpy(leaf).to(torch.bfloat16).float()
            np.testing.assert_array_equal(as_bf16.numpy(), leaf)
    _close(got, want, **F32)


def test_int8_ef_mean_matches_reference_with_residual():
    rng = np.random.default_rng(7)
    tree, ef = _tree(rng), _tree(rng)
    ef = jax.tree.map(lambda x: (x * 0.01).astype(np.float32), ef)
    got, got_ef = tmerge.int8_ef_mean(_to_torch(tree), _to_torch(ef))
    want, want_ef = jmerge.int8_ef_mean(jax.tree.map(jnp.asarray, tree),
                                        jax.tree.map(jnp.asarray, ef),
                                        mesh=None)
    _close(got, want, **F32)
    _close(got_ef, want_ef, **RESIDUAL)
    # the residual is exactly what each pod failed to send
    for x, r, m in zip(jax.tree.leaves(_to_torch(tree)),
                       jax.tree.leaves(_to_torch(ef)),
                       jax.tree.leaves(got)):
        assert m.shape == x.shape and m.dtype == torch.float32
        assert torch.equal(m[0], m[-1])          # one merged value per pod


def test_int8_sum_wraps_like_the_reference():
    """Two pods at +63.5 steps each round to 64 and sum to 128, which wraps
    in int8 on both sides."""
    x = np.array([[1.0, 127.0 / 2], [1.0, 127.0 / 2]], np.float32)
    zero = np.zeros_like(x)
    got, _ = tmerge.int8_ef_mean([torch.from_numpy(x)],
                                 [torch.from_numpy(zero)])
    want, _ = jmerge.int8_ef_mean([jnp.asarray(x)], [jnp.asarray(zero)],
                                  mesh=None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("levels", [127, 15])
def test_compression_matches_reference(levels):
    x = np.random.default_rng(levels).standard_normal((7, 33)).astype(
        np.float32)
    q, s = tcomp.quantize_int8(torch.from_numpy(x), levels)
    jq, js = jcomp.quantize_int8(jnp.asarray(x), levels)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(tcomp.dequantize_int8(q, s).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js)))
    np.testing.assert_allclose(
        tcomp.quantization_residual(torch.from_numpy(x), q, s).numpy(),
        np.asarray(jcomp.quantization_residual(jnp.asarray(x), jq, js)),
        rtol=1e-6, atol=1e-7)


def test_pod_replicate_and_slice():
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(4)]}
    rep = tk.pod_replicate(tree, 3)
    assert rep["a"].shape == (3, 2, 3) and rep["a"].is_contiguous()
    rep["a"][1] += 1                     # replicas own their storage
    assert torch.equal(rep["a"][0], tree["a"])
    assert torch.equal(tk.pod_slice(rep, 2)["b"][0], torch.ones(4))
    with pytest.raises(ValueError, match="unknown merge"):
        tmerge.make_merge_fn("ring")
    with pytest.raises(NotImplementedError, match="A8"):
        tmerge.spec_aware_mean(tree, specs={"a": None})
