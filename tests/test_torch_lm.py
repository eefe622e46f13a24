"""The port's LM prefill (qwen3-14b) against the reference.

Both sides start from one state: the reference's ``init_params``, exported
as numpy (norms and biases redrawn around their initial values with numpy,
so they matter) and loaded through ``interop.lm_from_reference``; the
tokens come from numpy.  The reference's Pallas flash kernel runs in
interpret mode, as ``tests/test_flash_attention.py`` runs it; its model path
calls ``_sdpa_dense`` (S <= 1024) or ``_sdpa_qblocked`` (above), the
port's ``ops.flash_attention`` (the plain version on the CPU).

Tolerances (each check states its own):
- attention, float32: atol = rtol = 1e-5 (the same float32 math, summed in
  another order); bfloat16: atol 4e-3, rtol 8e-3 (the same float32 math,
  then one rounding to bfloat16's 8 bits: at most an ulp apart);
- rms_norm and RoPE: float32 atol = rtol = 1e-6; bfloat16 within one ulp;
- logits, float32: atol 5e-5 at smoke size (|logits| < 7) and 3e-4 at the
  published widths (products of widths 5120 and 17408 summed in other
  orders);
- logits, bfloat16: max |diff| <= 0.125 and mean |diff| <= 0.03 (every op
  rounds to 8 bits in both, and the reference rounds the softmax
  probabilities to bfloat16 before the product with v, where the port,
  like the TPU kernel, keeps them in float32); and the port's distance
  from the float32 computation on the same weights at most 1.25 times the
  reference's own (max and mean).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import common as JC
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.interop import lm_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (bf16_ulps,
                                                  flash_attention_cuda)
from repro_torch.launch import train as launch
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.runtime.factory import build_trainer
from repro_torch.runtime.trainer import TrainerConfig

JSMOKE = jconfigs.get("qwen3-14b").smoke_cfg
SMOKE = configs.get("qwen3-14b").smoke_cfg
ATTN_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
            "bfloat16": dict(atol=4e-3, rtol=8e-3)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32", **kw):
    """The smoke config in both packages, with ``dtype`` and ``kw``."""
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(JSMOKE, dtype=jdt, **kw),
            dataclasses.replace(SMOKE, dtype=tdt, **kw))


def _state(jcfg, seed=0):
    """One state for both packages: the reference's init, with the norms and
    biases redrawn around their initial values, as numpy."""
    params = jax.device_get(JT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def redraw(x, base):
        return (base + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)

    layers = dict(params["layers"])
    for k in ("attn_norm", "ffn_norm", "q_norm", "k_norm", "bq", "bk", "bv"):
        if k in layers:
            layers[k] = redraw(layers[k], 1.0 if k.endswith("norm") else 0.0)
    params = dict(params, layers=layers,
                  final_norm=redraw(params["final_norm"], 1.0))
    return params


def _tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed + 1).integers(0, vocab, (B, S)).astype(
        np.int32)


def _prefill_both(jcfg, tcfg, B, S, seed=0):
    """(port, reference) prefill logits as float32 numpy, from one state."""
    params = _state(jcfg, seed)
    tokens = _tokens(jcfg.vocab, B, S, seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = jax.jit(JT.prefill, static_argnums=2)(jparams, jnp.asarray(tokens),
                                                 jcfg)
    got = T.prefill(lm_from_reference(params, device="cpu"),
                    torch.from_numpy(tokens), tcfg)
    assert got.dtype == tcfg.dtype and got.shape == (B, tcfg.vocab)
    return got.float().numpy(), np.asarray(want, np.float32)


# ------------------------------------------------------------------ configs
# each registered LM: its full config's parameters, the port's and the
# reference's source tags (the reference's qwen3-14b names Qwen3-8B)
LM_ARCHS = {
    "qwen3-14b": (14_768_296_960, "hf:Qwen/Qwen3-14B; hf",
                  "hf:Qwen/Qwen3-8B; hf"),
    "qwen2-7b": (7_615_487_488, "arXiv:2407.10671; hf",
                 "arXiv:2407.10671; hf"),
    "granite-8b": (8_254_689_280, "arXiv:2405.04324; hf",
                   "arXiv:2405.04324; hf"),
    "mixtral-8x7b": (46_702_792_704, "arXiv:2401.04088; hf",
                     "arXiv:2401.04088; hf"),
    "llama4-scout-17b-16e": (
        107_769_861_120, "hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
        "hf:meta-llama/Llama-4-Scout-17B-16E; unverified"),
}


@pytest.mark.parametrize("arch", sorted(LM_ARCHS))
def test_configs_match_the_reference(arch):
    spec, jspec = configs.get(arch), jconfigs.get(arch)
    jfields = {f.name: f for f in dataclasses.fields(JT.TransformerConfig)}
    fields = [f.name for f in dataclasses.fields(T.TransformerConfig)]
    assert set(fields) <= set(jfields)
    # the reference's fields the port leaves out: its attention choice, at
    # its defaults in every config the port takes
    dropped = set(jfields) - set(fields)
    assert dropped == {"dense_attn_threshold", "attn_block_kv",
                       "attn_block_q"}
    for name in ("model_cfg", "smoke_cfg"):
        got, want = getattr(spec, name), getattr(jspec, name)
        for f in fields:
            if f != "dtype":
                assert getattr(got, f) == getattr(want, f), (name, f)
        for f in dropped:
            assert getattr(want, f) == jfields[f].default, (name, f)
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        assert got.hd == want.hd
        assert got.total_params() == want.total_params()
        assert got.active_params() == want.active_params()
    # qwen3-14b: 29.5 GB of bfloat16 (the formula leaves out the qk-norm
    # scales)
    params, source, jsource = LM_ARCHS[arch]
    assert spec.model_cfg.total_params() == params
    assert spec.family == jspec.family == "lm"
    assert spec.source == source
    assert jspec.source == jsource
    got, want = spec.shapes, jspec.shapes
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k].kind, got[k].dims, got[k].skip) == (
            want[k].kind, want[k].dims, want[k].skip)
    assert got["prefill_32k"].dims == {"seq": 32768, "batch": 32}
    assert got["decode_32k"].dims == {"seq": 32768, "batch": 128}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-16e",
                                  "gin-tu"])
def test_unported_archs_stay_unregistered(arch):
    """mixtral-8x7b and llama4-scout-17b-16e, unregistered until A10d's
    serving path, and gin-tu, unregistered until A10e, now resolve to the
    reference's arch of the same name and family (gin-tu with the
    reference's model and smoke widths)."""
    jspec = jconfigs.get(arch)
    spec = configs.get(arch)
    assert spec.name == jspec.name == arch
    assert spec.family == jspec.family
    if arch not in LM_ARCHS:
        for name in ("model_cfg", "smoke_cfg"):
            for f in ("n_layers", "d_in", "d_hidden", "n_classes",
                      "train_eps", "readout", "pre_project"):
                assert getattr(getattr(spec, name), f) == getattr(
                    getattr(jspec, name), f)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,S,hd,bq,bkv", [
    (2, 64, 16, 16, 16),
    (4, 128, 32, 32, 64),
    (1, 256, 64, 64, 32),
])
def test_flash_ref_matches_pallas_kernel(dtype, causal, BH, S, hd, bq, bkv):
    """The plain version against the TPU kernel in interpret mode, on the
    reference kernel test's grid.  The kernel takes (BH, S, hd); the port's
    layout takes it as one batch of BH heads, (1, S, BH, hd), Kv = BH."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    q, k, v = [rng.standard_normal((BH, S, hd)).astype(np.float32)
               for _ in range(3)]
    want = flash_attention_pallas(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                  causal=causal, block_q=bq, block_kv=bkv,
                                  interpret=True)
    tq, tk, tv = [torch.from_numpy(x).to(tdt).transpose(0, 1)[None]
                  .contiguous() for x in (q, k, v)]
    got = tref.flash_attention_ref(tq, tk, tv, causal)
    assert got.dtype == tdt
    np.testing.assert_allclose(got[0].transpose(0, 1).float().numpy(),
                               np.asarray(want, np.float32),
                               **ATTN_TOL[dtype])


def test_flash_ref_gqa_matches_model_attention_and_pallas():
    """GQA (H 4, Kv 2): the plain version against the reference model's
    ``_sdpa_dense`` (float32) and against the TPU kernel with K and V
    repeated per group (the reference test's flattening), in float32 and
    bfloat16."""
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(1)
    B, S, H, Kv, hd = 2, 64, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = [rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
            for _ in range(2)]
    pos = jnp.arange(S, dtype=jnp.int32)
    want = np.asarray(JT._sdpa_dense(jcfg, 0, *map(jnp.asarray, (q, k, v)),
                                     pos, pos))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tref.flash_attention_ref(tq, tk, tv, True).numpy()
    np.testing.assert_allclose(got, want, **ATTN_TOL["float32"])
    G = H // Kv
    qf = q.transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    kf, vf = [np.repeat(x.transpose(0, 2, 1, 3), G, axis=1).reshape(
        B * H, S, hd) for x in (k, v)]
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = DTYPES[dtype]
        pallas = flash_attention_pallas(
            *(jnp.asarray(x, jdt) for x in (qf, kf, vf)), causal=True,
            block_q=16, block_kv=16, interpret=True)
        pallas = np.asarray(pallas, np.float32).reshape(
            B, H, S, hd).transpose(0, 2, 1, 3)
        got = tref.flash_attention_ref(*(x.to(tdt) for x in (tq, tk, tv)),
                                       True)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), pallas,
                                   **ATTN_TOL[dtype])


def _mma_kernel_arithmetic(q, k, v, causal, p_as="halves", tile=64):
    """The bfloat16 kernel's arithmetic (``csrc/flash_attention.cu``, the
    mma kernel) in float64 torch, on bf16 q, k, v in the model's layout:
    exact bf16 products summed and rounded to float32 (the mma's float32
    sums, up to their order), the scale after the sum, the online softmax
    over fixed 64-column tiles with float32 m, l and p, and P V from p's two
    bf16 halves, ``acc * corr + p_hi v + p_lo v`` in float32.  ``p_as``
    "once" rounds p to bf16 alone (SDPA's way), "float32" keeps it whole:
    the controls."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qg = q.double().reshape(B, S, Kv, H // Kv, hd)
    pos = torch.arange(S)
    m = torch.full((B, Kv, H // Kv, S, 1), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Kv, H // Kv, S, hd))
    for k0 in range(0, S, tile):
        kt, vt = k[:, k0:k0 + tile].double(), v[:, k0:k0 + tile].double()
        s = torch.einsum("bskgd,btkd->bkgst", qg, kt).float() * scale
        if causal:
            s.masked_fill_(pos[k0:k0 + tile][None, :] > pos[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16)
        parts = {"halves": (hi, (p - hi.float()).to(torch.bfloat16)),
                 "once": (hi,), "float32": (p,)}[p_as]
        acc = acc * corr
        for part in parts:
            acc = acc + torch.einsum("bkgst,btkd->bkgsd", part.double(),
                                     vt).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,S,hd,bq,bkv", [
    (2, 64, 16, 16, 16),
    (4, 128, 32, 32, 64),
    (1, 256, 64, 64, 32),
    (2, 200, 128, 40, 40),
])
def test_mma_kernel_arithmetic_matches_pallas_kernel(causal, BH, S, hd, bq,
                                                     bkv):
    """The bf16 kernel's arithmetic (tensor-core products, the scale after
    the sum, p in two bf16 halves) against the TPU kernel in interpret mode
    on bf16 inputs.  Tolerance: one bf16 ulp per element (``bf16_ulps``),
    the two computations being the same float32 math up to one rounding of
    the scale, p carried to 2^-18 and the sums' order; a p rounded once to
    bf16 would be tens of ulps off."""
    rng = np.random.default_rng(S + hd)
    q, k, v = [rng.standard_normal((BH, S, hd)).astype(np.float32)
               for _ in range(3)]
    want = flash_attention_pallas(*(jnp.asarray(x, jnp.bfloat16)
                                    for x in (q, k, v)),
                                  causal=causal, block_q=bq, block_kv=bkv,
                                  interpret=True)
    want = torch.from_numpy(np.asarray(want, np.float32))
    tq, tk, tv = [torch.from_numpy(x).to(torch.bfloat16).transpose(0, 1)[None]
                  .contiguous() for x in (q, k, v)]
    got = _mma_kernel_arithmetic(tq, tk, tv, causal)[0].transpose(0, 1)
    assert got.dtype == torch.bfloat16
    assert bf16_ulps(got, want).max().item() <= 1.0


def test_one_ulp_check_rejects_p_rounded_once():
    """The control: the same arithmetic with p rounded once to bf16 lies
    more than one ulp (``bf16_ulps``) from the TPU kernel, so the check
    above tells the two halves from SDPA's rounding."""
    rng = np.random.default_rng(200 + 128)
    q, k, v = [rng.standard_normal((2, 200, 128)).astype(np.float32)
               for _ in range(3)]
    want = flash_attention_pallas(*(jnp.asarray(x, jnp.bfloat16)
                                    for x in (q, k, v)),
                                  causal=True, block_q=40, block_kv=40,
                                  interpret=True)
    want = torch.from_numpy(np.asarray(want, np.float32))
    tq, tk, tv = [torch.from_numpy(x).to(torch.bfloat16).transpose(0, 1)[None]
                  .contiguous() for x in (q, k, v)]
    once = _mma_kernel_arithmetic(tq, tk, tv, True, p_as="once")
    assert bf16_ulps(once[0].transpose(0, 1), want).max().item() > 8.0


def test_one_ulp_check_needs_the_row_floor():
    """Why ``bf16_ulps`` measures an element below 2^-8 of its row's largest
    magnitude in the ulp at that magnitude: the plain version's own
    arithmetic with the sums in the kernel's order (p kept in float32, no
    halves) already puts some such elements more than one of their own
    ulps from the plain version, while every element stays within one
    ``bf16_ulps``."""
    gen = torch.Generator().manual_seed(53)
    q = torch.randn((1, 512, 8, 128), generator=gen).bfloat16()
    k, v = [torch.randn((1, 512, 2, 128), generator=gen).bfloat16()
            for _ in range(2)]
    want = tref.flash_attention_ref(q, k, v, True)
    got = _mma_kernel_arithmetic(q, k, v, True, p_as="float32")
    w = want.float()
    own_ulp = torch.ldexp(torch.ones_like(w), torch.frexp(
        w.abs().clamp_min(2.0 ** -126))[1] - 8)
    assert ((got.float() - w).abs() / own_ulp).max().item() > 1.0
    assert bf16_ulps(got, want).max().item() <= 1.0


def test_flash_attention_dispatch_on_the_cpu():
    """A CPU tensor runs the counted plain version, under autograd."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 8)).astype(np.float32))
    k, v = [torch.from_numpy(rng.standard_normal((1, 9, 2, 8)).astype(
        np.float32)) for _ in range(2)]
    ops.reset_launches()
    x = q.clone().requires_grad_(True)
    out = ops.flash_attention(x, k, v)
    out.sum().backward()
    assert ops.launches["flash_attention_ref"] == 1
    assert ops.launches["flash_attention"] == 0
    assert torch.equal(out, tref.flash_attention_ref(q, k, v, True))
    assert x.grad is not None and torch.isfinite(x.grad).all()
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)


# -------------------------------------------------------- norms and RoPE
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_the_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    tol = (dict(atol=1e-6, rtol=1e-6) if dtype == "float32"
           else dict(atol=0, rtol=2.0 ** -8))
    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal((2, 33, 4, 16))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    pos = np.tile(np.arange(33, dtype=np.int32) * 37, (2, 1))
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    want = JC.rms_norm(jx, jnp.asarray(scale, jdt), 1e-6)
    got = C.rms_norm(tx, torch.from_numpy(scale).to(tdt), 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    want = JC.apply_rope(jx, jnp.asarray(pos), 1e6)
    got = C.apply_rope(tx, torch.from_numpy(pos), 1e6)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(C.rope_freqs(128, 1e6).numpy(),
                               np.asarray(JC.rope_freqs(128, 1e6)),
                               rtol=1e-6)


def test_he_init_fan_in():
    """``fan_in`` overrides ``shape[-2]`` (the LM's embed is (vocab, d) with
    fan_in = d)."""
    g = torch.Generator("cpu").manual_seed(0)
    w = C.he_init(g, (4096, 64), device="cpu", fan_in=64)
    assert abs(float(w.std()) - (2.0 / 64) ** 0.5) < 0.01
    g = torch.Generator("cpu").manual_seed(0)
    assert torch.equal(C.he_init(g, (4096, 64), device="cpu"),
                       w * (64 / 4096) ** 0.5)


# ---------------------------------------------------------------- interop
def test_lm_from_reference_carries_every_leaf_bit_equal():
    jcfg, _ = _cfgs("bfloat16", qkv_bias=True, tie_embeddings=True)
    params = _state(jcfg)
    got = lm_from_reference(params, device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    assert len(flat) == 16     # embed, final_norm, 14 stacked layer leaves
    for path, want in flat:
        leaf = got
        for p in path:
            leaf = leaf[p.key]
        assert leaf.dtype == torch.bfloat16 and tuple(leaf.shape) == want.shape
        assert np.array_equal(leaf.view(torch.int16).numpy().view(np.uint16),
                              want.view(np.uint16)), path
    jcfg, _ = _cfgs("float32")
    params = _state(jcfg)
    got = lm_from_reference(params, device="cpu")
    assert "head" in got and got["head"].dtype == torch.float32
    assert np.array_equal(got["layers"]["wq"].numpy(),
                          params["layers"]["wq"])


def test_init_params_tree_and_distributions():
    """The reference's tree, shapes and dtypes; He-normal stds by the
    reference's fan_in; ones and zeros for the norms and biases."""
    jcfg, tcfg = _cfgs("float32", qkv_bias=True)
    want = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    got = T.init_params(torch.Generator("cpu").manual_seed(0), tcfg,
                        device="cpu")
    jflat = {jax.tree_util.keystr(p): x for p, x in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    tflat = {jax.tree_util.keystr(p): x for p, x in
             jax.tree_util.tree_flatten_with_path(got)[0]}
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert tuple(tflat[k].shape) == jflat[k].shape, k
        assert tflat[k].dtype == torch.float32
    L = got["layers"]
    assert torch.equal(L["attn_norm"], torch.ones_like(L["attn_norm"]))
    assert torch.equal(L["bq"], torch.zeros_like(L["bq"]))
    d, F = tcfg.d_model, tcfg.d_ff
    for name, fan in (("wq", d), ("wo", tcfg.n_heads * tcfg.hd),
                      ("w_down", F)):
        assert abs(float(L[name].std()) / (2.0 / fan) ** 0.5 - 1) < 0.05
    assert abs(float(got["embed"].std()) / (2.0 / d) ** 0.5 - 1) < 0.05
    # layers are distinct draws
    assert not torch.equal(L["wq"][0], L["wq"][1])


# ---------------------------------------------------------------- prefill
@pytest.mark.parametrize("S", [64, 1536])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_the_reference(dtype, S):
    """qwen3 smoke (2 layers, d 128, 8 heads over 2 KV heads, hd 16); at
    S 1536 the reference takes ``_sdpa_qblocked``."""
    jcfg, tcfg = _cfgs(dtype)
    got, want = _prefill_both(jcfg, tcfg, B=2, S=S)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
        return
    diff = np.abs(got - want)
    assert diff.max() <= 0.125 and diff.mean() <= 0.03, (diff.max(),
                                                        diff.mean())
    # and the port is no farther than the reference from the float32
    # computation on the same bfloat16 weights (within 25 %)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                    _state(jcfg))
    f32 = np.asarray(JT.prefill(params, jnp.asarray(_tokens(jcfg.vocab, 2,
                                                             S)),
                                dataclasses.replace(jcfg, dtype=jnp.float32)))
    port, ref = np.abs(got - f32), np.abs(want - f32)
    assert port.max() <= 1.25 * ref.max(), (port.max(), ref.max())
    assert port.mean() <= 1.25 * ref.mean(), (port.mean(), ref.mean())


def test_prefill_with_qkv_bias_and_tied_embeddings_matches_the_reference():
    jcfg, tcfg = _cfgs("float32", qkv_bias=True, tie_embeddings=True)
    got, want = _prefill_both(jcfg, tcfg, B=2, S=64)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_forward_matches_the_reference():
    jcfg, tcfg = _cfgs("float32")
    params = _state(jcfg)
    tokens = _tokens(jcfg.vocab, 2, 64)
    want, jaux = JT.forward(jax.tree_util.tree_map(jnp.asarray, params),
                            jnp.asarray(tokens), jcfg)
    got, aux = T.forward(lm_from_reference(params, device="cpu"),
                         torch.from_numpy(tokens), tcfg)
    assert got.shape == (2, 64, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=0)
    assert float(aux) == float(jaux) == 0.0


def test_prefill_at_full_width_matches_the_reference():
    """qwen3-14b's published widths (d 5120, 40 heads over 8 KV heads, hd
    128, d_ff 17408), 2 layers, vocab cut to 4096, float32, 1 x 1536 (the
    reference's ``_sdpa_qblocked``): logits within atol 3e-4."""
    jcfg = dataclasses.replace(jconfigs.get("qwen3-14b").model_cfg,
                               n_layers=2, vocab=4096, dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get("qwen3-14b").model_cfg,
                               n_layers=2, vocab=4096, dtype=torch.float32)
    got, want = _prefill_both(jcfg, tcfg, B=1, S=1536)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)


# ------------------------------------------------- the head and the cut
def test_prefill_is_the_last_position_of_forward():
    _, tcfg = _cfgs("float32")
    params = T.init_params(torch.Generator("cpu").manual_seed(4), tcfg,
                           device="cpu")
    tokens = torch.from_numpy(_tokens(tcfg.vocab, 3, 50))
    last = T.prefill(params, tokens, tcfg)
    full, _ = T.forward(params, tokens, tcfg)
    torch.testing.assert_close(last, full[:, -1], atol=1e-6, rtol=1e-6)


def test_trunk_is_causal_in_its_prefix():
    """The hidden states of the first 96 positions do not depend on the
    tokens after them: a run of 96 and a run of 200 tokens agree there
    (atol = rtol = 1e-5, float32; the products of 96 and 200 rows may sum
    in other orders)."""
    _, tcfg = _cfgs("float32")
    params = T.init_params(torch.Generator("cpu").manual_seed(5), tcfg,
                           device="cpu")
    tokens = torch.from_numpy(_tokens(tcfg.vocab, 2, 200))
    long, _ = T.trunk(params, tokens, tcfg)
    short, _ = T.trunk(params, tokens[:, :96], tcfg)
    torch.testing.assert_close(long[:, :96], short, atol=1e-5, rtol=1e-5)
    other = tokens.clone()
    other[:, 96:] = (other[:, 96:] + 1) % tcfg.vocab
    changed, _ = T.trunk(params, other, tcfg)
    torch.testing.assert_close(changed[:, :96], long[:, :96], atol=1e-5,
                               rtol=1e-5)
    assert not torch.allclose(changed[:, 96:], long[:, 96:])


# ------------------------------------------------ rejections and defaults
@pytest.mark.parametrize("field,value,item", [
    ("n_experts", 8, "A10d"), ("attn_window", 64, "A10d"),
    ("attn_chunk", 64, "A10d"), ("seq_shard", True, "A8"),
])
def test_unported_fields_raise_naming_their_items(field, value, item):
    """seq_shard (A8) raises everywhere.  MoE and the windowed and chunked
    masks serve (A10d: init_params and prefill run) and train (A10d
    training): ``build_trainer`` builds a ``DenseTrainer`` over them whose
    step takes a finite loss."""
    from repro_torch.runtime.factory import build_trainer

    _, tcfg = _cfgs("float32")
    bad = dataclasses.replace(tcfg, **{field: value})
    g = torch.Generator("cpu").manual_seed(0)
    if item == "A10d":
        params = T.init_params(g, bad, device="cpu")
        out = T.prefill(params, torch.zeros((1, 4), dtype=torch.int32), bad)
        assert out.shape == (1, bad.vocab) and torch.isfinite(out).all()
        tr = build_trainer("qwen3-14b", TrainerConfig(), model_cfg=bad,
                           device="cpu")
        toks = np.random.default_rng(4).integers(0, bad.vocab, (2, 65))
        loss = tr.train_step({"tokens": toks[:, :-1],
                              "labels": toks[:, 1:]})
        assert math.isfinite(float(loss))
        return
    with pytest.raises(NotImplementedError, match=item):
        T.init_params(g, bad, device="cpu")
    params = T.init_params(g, tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        T.prefill(params, torch.zeros((1, 4), dtype=torch.int32), bad)


def test_lm_training_runs_through_the_entry_points(capsys):
    """``build_trainer`` gives a ``DenseTrainer`` that takes steps with
    finite losses and counts the attention's plain backward; the launcher
    trains and prints the reference's final line."""
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.runtime.trainer import DenseTrainer

    tr = build_trainer("qwen3-14b", TrainerConfig(), device="cpu")
    assert isinstance(tr, DenseTrainer)
    gen = lm_batches(seed=0, batch=2, seq_len=16, vocab=SMOKE.vocab)
    ops.reset_launches()
    losses = [float(tr.train_step(next(gen))) for _ in range(2)]
    assert all(math.isfinite(x) for x in losses)
    # each layer's attention runs twice (forward, and again when the
    # checkpointed layer is recomputed), its backward once
    assert ops.launches["flash_attention_ref"] == 2 * 2 * SMOKE.n_layers
    assert ops.launches["flash_attention_backward_ref"] == 2 * SMOKE.n_layers
    launch.main(["--arch", "qwen3-14b", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("final loss n/a (steps < log_every) (")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("float32")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        T.init_params(torch.Generator("cpu"), tcfg)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        lm_from_reference({"embed": np.zeros((2, 2), np.float32)})
