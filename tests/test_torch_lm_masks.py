"""The sliding-window and chunked masks, and the two archs that use them
(mixtral-8x7b, llama4-scout-17b-16e), against the reference: ``_mask``,
the plain flash attention under the local terms, ``forward``,
``decode_step`` over the ring cache and the ``BatchedServer``.

Both sides start from one state (``test_torch_lm._state``); tokens and
activations come from numpy.

Tolerances (each check states its own):
- ``_mask``: bit-equal;
- attention, float32: atol = rtol = 1e-5 (the same float32 math, summed in
  another order);
- logits and aux, float32: atol 2e-5 (products of widths 128 and 256
  summed in other orders, through two or four layers and the MoE);
  decode against ``forward``: atol 2e-4 (the reference's own
  ``test_decode_matches_forward``);
- ``pos``, ``t`` and the server's tokens: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.interop import lm_cache_to_reference, lm_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve_lm
from repro_torch.models import transformer as T
from test_torch_decode import _ref_decode, _serve_both
from test_torch_lm import _state, _tokens

ARCHS = ["mixtral-8x7b", "llama4-scout-17b-16e"]


def _smoke(arch, **kw):
    return (dataclasses.replace(jconfigs.get(arch).smoke_cfg, **kw),
            dataclasses.replace(configs.get(arch).smoke_cfg, **kw))


def _models(jcfg, seed=0):
    params = _state(jcfg, seed)
    return (jax.tree_util.tree_map(jnp.asarray, params),
            lm_from_reference(params, device="cpu"))


def _window(tcfg):
    """The arch's local span: its window, else its chunk."""
    return tcfg.attn_window or tcfg.attn_chunk


# ------------------------------------------------------------------ _mask
MASK_CASES = {
    "window": dict(attn_window=5),
    "chunk": dict(attn_chunk=4),
    "window+chunk": dict(attn_window=3, attn_chunk=8),
    "chunk+global": dict(attn_chunk=4, global_every=3),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_mask_is_the_references_bit_for_bit(case):
    """Prefill positions 0..S-1, decode (one query over a ring with empty
    slots, kv_pos -1) and a query block, at every layer index 0..7 (the
    global layers of ``global_every``)."""
    base = jconfigs.get("qwen3-14b").smoke_cfg
    jcfg = dataclasses.replace(base, **MASK_CASES[case])
    tcfg = dataclasses.replace(configs.get("qwen3-14b").smoke_cfg,
                               **MASK_CASES[case])
    pos = np.arange(21, dtype=np.int32)
    ring = np.asarray([16, 17, 18, 19, 20, 11, 12, 13, 14, 15, -1, -1],
                      np.int32)
    for q_pos, kv_pos in ((pos, pos), (np.asarray([20], np.int32), ring),
                          (pos[9:14], pos)):
        for layer in range(8):
            want = np.asarray(JT._mask(jcfg, jnp.int32(layer),
                                       jnp.asarray(q_pos),
                                       jnp.asarray(kv_pos)))
            got = T._mask(tcfg, layer, torch.from_numpy(q_pos),
                          torch.from_numpy(kv_pos))
            assert got.dtype == torch.bool
            assert np.array_equal(got.numpy(), want), (case, layer)


@pytest.mark.parametrize("S,window,chunk", [
    (37, 5, None), (37, None, 8), (40, 6, 16), (24, 64, None),
    (24, None, 24),
])
def test_plain_flash_attention_matches_the_references_masked_sdpa(S, window,
                                                                  chunk):
    """``ref.flash_attention_ref(window=, chunk=)`` and ``ops`` on the CPU
    against the reference's ``_sdpa_dense`` under ``_mask`` (f32, GQA 8
    heads over 2, hd 16); terms of S or more mask nothing past causal."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 8, 16)).astype(np.float32)
    k, v = [rng.standard_normal((2, S, 2, 16)).astype(np.float32)
            for _ in range(2)]
    jcfg = dataclasses.replace(jconfigs.get("qwen3-14b").smoke_cfg,
                               attn_window=window, attn_chunk=chunk)
    pos = jnp.arange(S, dtype=jnp.int32)
    want = np.asarray(JT._sdpa_dense(jcfg, 0, jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), pos, pos))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tref.flash_attention_ref(tq, tk, tv, True, window, chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    ops.reset_launches()
    again = ops.flash_attention(tq, tk, tv, window=window, chunk=chunk)
    assert torch.equal(again, got)
    assert ops.launches["flash_attention_ref"] == 1
    lse = tref.flash_attention_lse_ref(tq, tk, True, window, chunk)
    m = tref.attention_mask(S, True, window, chunk)
    s = torch.einsum("bskgd,btkd->bkgst",
                     tq.reshape(2, S, 2, 4, 16) / 4.0, tk)
    s = s.masked_fill(~m, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(2, 8, S),
                               atol=1e-5, rtol=1e-5)
    if (window or S) >= S and (chunk or S) >= S:
        assert torch.equal(got, tref.flash_attention_ref(tq, tk, tv, True))


def test_local_terms_are_checked():
    q = torch.zeros(1, 8, 2, 8)
    k = torch.zeros(1, 8, 1, 8)
    for kw in (dict(window=0), dict(chunk=-2), dict(window=2.5)):
        with pytest.raises(ValueError, match="positive int"):
            ops.flash_attention(q, k, k, **kw)
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(q, k, k, causal=False, window=4)
    assert tref.attention_mask(4, causal=False) is None
    assert tref.attention_mask(4, True, 2).tolist() == [
        [True, False, False, False], [True, True, False, False],
        [False, True, True, False], [False, False, True, True]]


# ----------------------------------------------------------- the archs
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch):
    """Each smoke config (f32) over 2 x 64 tokens, four windows or chunks:
    logits and the summed aux loss; prefill is forward's last position."""
    jcfg, tcfg = _smoke(arch)
    jparams, tparams = _models(jcfg)
    tokens = _tokens(jcfg.vocab, 2, 64)
    want, waux = jax.jit(JT.forward, static_argnums=2)(
        jparams, jnp.asarray(tokens), jcfg)
    got, aux = T.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(aux) > 0 and abs(float(aux) - float(waux)) <= 2e-5
    pre = T.prefill(tparams, torch.from_numpy(tokens), tcfg)
    assert torch.equal(pre, got[:, -1])


@pytest.mark.parametrize("arch", ARCHS)
def test_local_layers_pass_their_terms_to_the_flash_kernel(arch, monkeypatch):
    """Each layer's call: mixtral's window on every layer; llama4's chunk
    on its local layers and none on its global one (layer 3 of 4)."""
    _, tcfg = _smoke(arch)
    params = T.init_params(torch.Generator("cpu").manual_seed(0), tcfg,
                           device="cpu")
    seen = []
    flash = ops.flash_attention

    def spy(q, k, v, causal=True, window=None, chunk=None):
        seen.append((causal, window, chunk))
        return flash(q, k, v, causal, window, chunk)

    monkeypatch.setattr(ops, "flash_attention", spy)
    T.prefill(params, torch.zeros((1, 64), dtype=torch.int64), tcfg)
    if arch == "mixtral-8x7b":
        assert seen == [(True, 16, None)] * 2
    else:
        assert seen == [(True, None, 16)] * 3 + [(True, None, None)]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_the_reference(arch):
    """3 x window (mixtral: 48 steps over a 16-slot ring, wrapping twice;
    llama4: 48 steps across three chunks) of 2 slots, each package on its
    own cache: logits within 2e-5 at every step, ``pos`` and ``t``
    equal."""
    jcfg, tcfg = _smoke(arch)
    jparams, tparams = _models(jcfg, seed=1)
    n = 3 * _window(tcfg)
    tokens = _tokens(jcfg.vocab, n, 2, seed=2)
    jcache = JT.init_cache(jcfg, 2, 64)
    tcache = T.init_cache(tcfg, 2, 64, device="cpu")
    Skv = T.cache_len(tcfg, 64)
    assert tcache["k"].shape[3] == jcache["k"].shape[2] == Skv
    assert Skv == (16 if arch == "mixtral-8x7b" else 64)
    for tok in tokens:
        want, jcache = _ref_decode(jcfg, jparams, jcache, tok)
        got, tcache = T.decode_step(tparams, tcache, torch.from_numpy(tok),
                                    tcfg)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
        assert np.array_equal(tcache["pos"].numpy(),
                              np.asarray(jcache["pos"]))
        assert int(tcache["t"]) == int(jcache["t"])
    assert int(tcache["t"]) == n
    back = lm_cache_to_reference(tcache)
    for name in ("k", "v"):
        np.testing.assert_allclose(back[name], np.asarray(jcache[name]),
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("variant", ["swa", "chunked"])
def test_decode_matches_forward(variant):
    """The reference's ``test_decode_matches_forward[swa|chunked]`` (window
    6 or chunk 8, 2 x 20 tokens): the port's decode token by token against
    its own forward and the reference's, atol 2e-4."""
    kw = {"swa": dict(attn_window=6), "chunked": dict(attn_chunk=8)}[variant]
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=97, moe_group_size=64, **kw)
    jcfg = JT.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = T.TransformerConfig(dtype=torch.float32, **base)
    jparams, tparams = _models(jcfg, seed=4)
    tokens = _tokens(97, 2, 20, seed=5)
    want, _ = JT.forward(jparams, jnp.asarray(tokens), jcfg)
    mine, _ = T.forward(tparams, torch.from_numpy(tokens), tcfg)
    cache = T.init_cache(tcfg, 2, 20, device="cpu")
    outs = []
    for i in range(20):
        logits, cache = T.decode_step(tparams, cache,
                                      torch.from_numpy(tokens[:, i]), tcfg)
        outs.append(logits)
    got = torch.stack(outs, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), mine.numpy(), atol=2e-4, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_the_reference_server(arch):
    """12 seeded requests (prompts of 2 to 9 tokens, 3 to 8 new) over 3
    slots: token for token and the same stats; ``t`` passes the ring's 16
    slots (mixtral) and two chunks (llama4)."""
    jcfg, tcfg = _smoke(arch)
    jparams, tparams = _models(jcfg, seed=3)
    rng = np.random.default_rng(12)
    requests = [(rng.integers(0, jcfg.vocab, rng.integers(2, 10)).tolist(),
                 int(rng.integers(3, 9))) for _ in range(12)]
    want, got, wstats, gstats = _serve_both(jcfg, tcfg, jparams, tparams,
                                            requests, slots=3, max_len=256)
    assert got == want
    assert [len(o) for o in got] == [n for _, n in requests]
    assert {k: v for k, v in gstats.items() if k != "wall"} == {
        k: v for k, v in wstats.items() if k != "wall"}
    calls = sum(len(p) - 1 for p, _ in requests) + gstats["steps"]
    assert calls > 2 * _window(tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_launcher_runs_the_arch(arch, capsys):
    stats = serve_lm.main(["--arch", arch, "--requests", "6", "--slots", "3",
                           "--max-new", "8", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={arch} (smoke config), slots=3"
    assert stats["decoded_tokens"] == 48


@pytest.mark.parametrize("arch", ARCHS)
def test_training_the_arch_raises_naming_a10d(arch):
    """Training the arch (A10d training: kernel 9b's window and chunk
    terms, the MoE backward; ``test_torch_moe_train`` holds it against the
    reference): ``build_trainer`` gives a ``DenseTrainer`` whose two steps
    take finite losses, each layer's attention under its window or chunk
    (the plain version, its recompute and its vjp counted)."""
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.trainer import DenseTrainer, TrainerConfig

    _, tcfg = _smoke(arch)
    tr = build_trainer(arch, TrainerConfig(), device="cpu")
    assert isinstance(tr, DenseTrainer)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (4, 65))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ops.reset_launches()
    losses = [float(tr.train_step(batch)) for _ in range(2)]
    assert all(np.isfinite(losses))
    n = 2 * tr.n_pod * tcfg.n_layers     # steps x pods x layers
    assert ops.launches["flash_attention_ref"] == 2 * n
    assert ops.launches["flash_attention_backward_ref"] == n
