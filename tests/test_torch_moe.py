"""The port's MoE FFN (``models/moe.py``) against the reference's
(``repro/models/moe.py``).

Both sides start from one state: the reference's ``init_params``, exported
as numpy (``test_torch_lm._state``) and loaded through
``interop.lm_from_reference``; the activations come from numpy.  The
reference's per-group plan is its ``_route_group`` under ``jax.vmap``.

Tolerances (each check states its own):
- the plan (``slot``, ``keep``, ``t_flat``): equal;
- float32: y within atol 1e-5 (products of width d and d_ff summed in
  other orders), aux within 1e-6;
- bfloat16: the plan equal; y max |diff| <= 0.125 and mean |diff| <= 0.03
  (the LM tests' bfloat16 tolerance: every op rounds to 8 bits in both),
  aux within 1e-6 (the router runs in float32 from the same bf16 logits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.interop import lm_from_reference
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from test_torch_lm import _state

ARCHS = ["mixtral-8x7b", "llama4-scout-17b-16e"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, dtype="float32", **kw):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(jconfigs.get(arch).smoke_cfg, dtype=jdt, **kw),
            dataclasses.replace(configs.get(arch).smoke_cfg, dtype=tdt, **kw))


def _layer(jcfg, seed=0, layer=0):
    """Layer ``layer`` of one state: (reference leaves, port leaves)."""
    params = _state(jcfg, seed)
    tparams = lm_from_reference(params, device="cpu")
    return ({k: jnp.asarray(v[layer]) for k, v in params["layers"].items()},
            {k: v[layer] for k, v in tparams["layers"].items()})


def _x(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(jcfg, tcfg, x, seed=0):
    """(reference (y, aux, plan), port (y, aux, plan)) for x (B, S, D)."""
    jlp, tlp = _layer(jcfg, seed)
    jx = jnp.asarray(x, jcfg.dtype)
    tx = torch.from_numpy(x).to(tcfg.dtype)
    y, aux = JM.moe_ffn(jx, jlp, jcfg)
    ty, taux = TM.moe_ffn(tx, tlp, tcfg)
    gsz, G = TM.groups(x.shape[0] * x.shape[1], tcfg.moe_group_size)
    cap = TM.capacity(gsz, tcfg.n_experts, tcfg.top_k, tcfg.capacity_factor)
    slot, t_flat, _, keep, _ = jax.vmap(lambda a: JM._route_group(
        a, jlp["router"], jcfg.n_experts, jcfg.top_k, cap))(
            jx.reshape(G, gsz, -1))
    plan, _ = TM.route(tx.reshape(G, gsz, -1), tlp["router"],
                       tcfg.n_experts, tcfg.top_k, cap)
    return ((np.asarray(y, np.float32), float(aux),
             (np.asarray(slot), np.asarray(keep), np.asarray(t_flat))),
            (ty.float().numpy(), float(taux), plan))


def _slot(plan, E, cap):
    """The reference's per-group slot ``e C + pos`` (dump ``E C``) of each
    choice, from its buffer row ``e G C + g C + pos`` (dump ``E G C``)."""
    G = plan.row.shape[0]
    e, rem = plan.row // (G * cap), plan.row % (G * cap)
    return torch.where(plan.keep, e * cap + rem % cap, E * cap)


def _same_plan(want, plan, tcfg):
    slot, keep, t_flat = want
    E, k = tcfg.n_experts, tcfg.top_k
    cap = TM.capacity(plan.t_flat.shape[0] // k, E, k, tcfg.capacity_factor)
    assert np.array_equal(_slot(plan, E, cap).numpy(), slot)
    assert np.array_equal(plan.keep.numpy(), keep)
    assert all(np.array_equal(plan.t_flat.numpy(), t) for t in t_flat)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_the_reference(arch):
    """Each smoke config (mixtral: 4 experts top-2; llama4: 4 experts top-1
    and a shared expert), 4 groups of 64 tokens, float32."""
    jcfg, tcfg = _cfgs(arch)
    (y, aux, want), (ty, taux, plan) = _both(jcfg, tcfg,
                                            _x((4, 64, jcfg.d_model)))
    _same_plan(want, plan, tcfg)
    assert ty.shape == y.shape and np.isfinite(ty).all()
    np.testing.assert_allclose(ty, y, atol=1e-5, rtol=0)
    assert abs(taux - aux) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_overflow_drops_as_the_reference(arch):
    """capacity_factor 0.5: experts fill, second choices and late tokens
    go to the dump slot and add nothing; the same choices drop."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.5)
    (y, aux, want), (ty, taux, plan) = _both(jcfg, tcfg,
                                            _x((2, 64, jcfg.d_model), 4))
    _same_plan(want, plan, tcfg)
    E = tcfg.n_experts
    cap = TM.capacity(64, E, tcfg.top_k, 0.5)
    dropped = ~plan.keep
    assert dropped.any() and plan.keep.any()
    G = plan.row.shape[0]
    assert bool((plan.row[dropped] == E * G * cap).all())
    assert bool((plan.row[plan.keep] < E * G * cap).all())
    np.testing.assert_allclose(ty, y, atol=1e-5, rtol=0)
    assert abs(taux - aux) <= 1e-6


def test_capacity_and_groups_follow_the_reference():
    assert TM.capacity(4096, 8, 2, 1.25) == 1280
    assert TM.capacity(4096, 16, 1, 1.25) == 320
    assert TM.capacity(1, 8, 2, 1.25) == 2        # at most gsz top_k
    assert TM.capacity(8, 8, 2, 1.25) == 8        # padded to 8
    assert TM.capacity(64, 4, 2, 0.5) == 16
    assert TM.groups(16384, 4096) == (4096, 4)
    assert TM.groups(8, 4096) == (8, 1)


def test_tokens_not_divisible_by_the_group_raise():
    jcfg, tcfg = _cfgs("mixtral-8x7b", moe_group_size=16)
    jlp, tlp = _layer(jcfg)
    x = _x((1, 24, jcfg.d_model))
    with pytest.raises(AssertionError, match="not divisible"):
        JM.moe_ffn(jnp.asarray(x), jlp, jcfg)
    with pytest.raises(ValueError, match="not divisible"):
        TM.moe_ffn(torch.from_numpy(x), tlp, tcfg)


def test_dense_dispatch_oracle():
    """The reference's ``test_moe_capacity_drops_consistent``: with ample
    capacity (2 experts, top-2, capacity_factor 4) nothing drops and the
    MoE equals every expert on every token, weighted by the router's
    probabilities; the port within atol 1e-4 (the reference's) of the
    oracle and 1e-5 of the reference."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=97, n_experts=2, top_k=2, moe_group_size=8,
              capacity_factor=4.0)
    jcfg = JT.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(configs.get("mixtral-8x7b").smoke_cfg,
                               attn_window=None, router_aux_coef=0.0, **kw)
    jlp, tlp = _layer(jcfg)
    x = _x((1, 8, 64), 5)
    y, _ = TM.moe_ffn(torch.from_numpy(x), tlp, tcfg)
    xt = torch.from_numpy(x.reshape(8, 64))
    probs = torch.softmax(xt @ tlp["router"], -1)
    silu = torch.nn.functional.silu
    expect = sum(probs[:, e:e + 1] * (
        (silu(xt @ tlp["we_gate"][e]) * (xt @ tlp["we_up"][e]))
        @ tlp["we_down"][e]) for e in range(2))
    np.testing.assert_allclose(y.reshape(8, 64).numpy(), expect.numpy(),
                               atol=1e-4, rtol=0)
    want, _ = JM.moe_ffn(jnp.asarray(x), jlp, jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_bfloat16_matches_the_reference(arch):
    """bfloat16 leaves and activations: the plan equal; y within the LM
    tests' bfloat16 tolerance (max |diff| <= 0.125, mean <= 0.03: both
    round every op to 8 bits, in their own order); aux within 1e-6."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    (y, aux, want), (ty, taux, plan) = _both(jcfg, tcfg,
                                            _x((4, 64, jcfg.d_model)))
    _same_plan(want, plan, tcfg)
    assert plan.w_flat.dtype == torch.bfloat16
    diff = np.abs(ty - y)
    assert diff.max() <= 0.125 and diff.mean() <= 0.03, (diff.max(),
                                                        diff.mean())
    assert abs(taux - aux) <= 1e-6


def test_top_k_takes_the_lower_index_of_ties_as_lax_top_k():
    probs = torch.tensor([[[0.25, 0.25, 0.25, 0.25],
                           [0.1, 0.4, 0.1, 0.4],
                           [0.5, 0.2, 0.2, 0.1]]])
    vals, idx = TM._top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    assert np.array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[[0, 1], [1, 3], [0, 1]]]


def test_dispatch_and_combine_layout():
    """Every kept choice's row lands in its expert's slot g C + pos of the
    (E, G C, D) buffer, empty slots stay zero, and combine of the buffer
    itself (experts the identity) gives x (sum of its renormalised top-k
    weights) for tokens that kept every choice."""
    _, tcfg = _cfgs("mixtral-8x7b")
    _, tlp = _layer(_cfgs("mixtral-8x7b")[0])
    x = torch.from_numpy(_x((2, 64, tcfg.d_model), 6))
    E, k = tcfg.n_experts, tcfg.top_k
    cap = TM.capacity(64, E, k, tcfg.capacity_factor)
    plan, _ = TM.route(x, tlp["router"], E, k, cap)
    xe = TM.dispatch(x, plan, E, cap)
    assert xe.shape == (E, 2 * cap, tcfg.d_model)
    filled = torch.zeros(E, 2 * cap, dtype=torch.bool)
    for g in range(2):
        for j in range(k * 64):
            if plan.keep[g, j]:
                e, p = divmod(int(_slot(plan, E, cap)[g, j]), cap)
                assert torch.equal(xe[e, g * cap + p],
                                   x[g, int(plan.t_flat[j])])
                filled[e, g * cap + p] = True
    assert not xe[~filled].any()
    out = TM.combine(xe, plan, 64)
    full = plan.keep.reshape(2, k, 64).all(1)
    torch.testing.assert_close(out[full], x[full], atol=1e-6, rtol=1e-6)


def test_lm_from_reference_carries_the_moe_leaves_bit_for_bit():
    """Both MoE smoke trees in bfloat16 (router, the experts' we_* (L, E,
    ., .) and llama4's shared ws_*): every leaf the reference's bits."""
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch, "bfloat16")
        params = _state(jcfg)
        got = lm_from_reference(params, device="cpu")
        names = {"router", "we_gate", "we_up", "we_down"}
        if tcfg.shared_expert:
            names |= {"ws_gate", "ws_up", "ws_down"}
        assert names <= set(got["layers"])
        assert "w_gate" not in got["layers"]
        flat, _ = jax.tree_util.tree_flatten_with_path(params)
        for path, want in flat:
            leaf = got
            for p in path:
                leaf = leaf[p.key]
            assert leaf.dtype == torch.bfloat16
            assert tuple(leaf.shape) == want.shape, path
            assert np.array_equal(
                leaf.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16)), path
        E, L = tcfg.n_experts, tcfg.n_layers
        assert tuple(got["layers"]["we_down"].shape) == (
            L, E, tcfg.d_ff, tcfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_moe_leaves(arch):
    """The reference's tree, shapes and dtypes for the MoE configs, each
    expert matrix its own He-normal draw with the reference's fan_in."""
    jcfg, tcfg = _cfgs(arch)
    want = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    got = T.init_params(torch.Generator("cpu").manual_seed(0), tcfg,
                        device="cpu")
    jflat = {jax.tree_util.keystr(p): x for p, x in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    tflat = {jax.tree_util.keystr(p): x for p, x in
             jax.tree_util.tree_flatten_with_path(got)[0]}
    assert jflat.keys() == tflat.keys()
    for key in jflat:
        assert tuple(tflat[key].shape) == jflat[key].shape, key
    L = got["layers"]
    d, F = tcfg.d_model, tcfg.d_ff
    for name, fan in (("router", d), ("we_gate", d), ("we_down", F)):
        assert abs(float(L[name].std()) / (2.0 / fan) ** 0.5 - 1) < 0.1
    assert not torch.equal(L["we_up"][0, 0], L["we_up"][0, 1])
    assert not torch.equal(L["we_up"][0, 0], L["we_up"][1, 0])

