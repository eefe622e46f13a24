"""The port's LM decode (``decode_step``) and ``BatchedServer`` against the
reference.

Both sides start from one state: the reference's ``init_params``, exported
as numpy with the norms and biases redrawn (``test_torch_lm._state``), and,
for a step from a filled cache, the reference's own cache after
``jax.device_get``, carried into the port's (L, B, Kv, Skv, hd) layout by
``interop.lm_cache_from_reference``.  Tokens and prompts come from numpy.

Tolerances (each check states its own):
- logits and the new K and V, float32: atol 5e-5 at smoke size (the
  prefill's), 2e-4 for decode against the reference's ``forward`` over 20
  positions (the reference's own ``test_decode_matches_forward``), 3e-4 at
  the published widths (the full-width prefill's);
- bfloat16: max |diff| <= 0.125 and mean |diff| <= 0.03 (the prefill's:
  every op rounds to 8 bits in both; decode rounds p to bfloat16 before
  ``p @ v`` as the reference does);
- the server's tokens: equal, token for token, in float32.
"""

import collections
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.runtime import serve as JS
from repro_torch import configs
from repro_torch.interop import (lm_cache_from_reference,
                                 lm_cache_to_reference, lm_from_reference)
from repro_torch.launch import serve_lm
from repro_torch.models import transformer as T
from repro_torch.runtime import serve as TS
from test_torch_lm import _cfgs, _state, _tokens


def _bf16_close(got, want):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.max() <= 0.125 and diff.mean() <= 0.03, (diff.max(),
                                                        diff.mean())


def _close(dtype, got, want, atol=5e-5):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    else:
        _bf16_close(got, want)


def _ref_decode(jcfg, jparams, cache, tokens):
    logits, cache = jax.jit(JT.decode_step, static_argnums=3)(
        jparams, cache, jnp.asarray(tokens), jcfg)
    return np.asarray(logits, np.float32), cache


def _models(jcfg, tcfg, seed=0):
    params = _state(jcfg, seed)
    return (jax.tree_util.tree_map(jnp.asarray, params),
            lm_from_reference(params, device="cpu"))


# ------------------------------------------------------------------ cache
def test_init_cache_and_cache_len():
    _, tcfg = _cfgs("bfloat16")
    cache = T.init_cache(tcfg, 3, 40, device="cpu")
    L, Kv, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.hd
    for n in ("k", "v"):
        assert cache[n].shape == (L, 3, Kv, 40, hd)
        assert cache[n].dtype == torch.bfloat16
        assert not cache[n].any()
    assert cache["pos"].dtype == torch.int32
    assert torch.equal(cache["pos"], torch.full((40,), -1, dtype=torch.int32))
    assert cache["t"].shape == () and int(cache["t"]) == 0
    assert cache["t"].dtype == torch.int32
    jcfg, _ = _cfgs("bfloat16")
    want = JT.init_cache(jcfg, 3, 40)
    assert want["k"].shape == (L, 3, 40, Kv, hd)
    got = lm_cache_to_reference(cache)
    for n in want:
        assert got[n].shape == want[n].shape, n
    # the ring buffer of a windowed model, as the reference's
    for seq, window in ((100, 6), (4, 6), (50, None)):
        jw = dataclasses.replace(jcfg, attn_window=window)
        tw = dataclasses.replace(tcfg, attn_window=window)
        assert T.cache_len(tw, seq) == JT.cache_len(jw, seq)
    assert T.cache_len(dataclasses.replace(tcfg, attn_window=6), 100) == 6


def test_cache_interop_carries_every_element_bit_for_bit():
    jcfg, tcfg = _cfgs("bfloat16")
    jparams, _ = _models(jcfg, tcfg)
    cache = JT.init_cache(jcfg, 2, 9)
    for tok in _tokens(jcfg.vocab, 5, 2).astype(np.int32):
        _, cache = _ref_decode(jcfg, jparams, cache, tok)
    want = jax.device_get(cache)
    got = lm_cache_from_reference(want, device="cpu")
    assert got["k"].shape == (tcfg.n_layers, 2, tcfg.n_kv_heads, 9, tcfg.hd)
    assert got["k"].is_contiguous() and got["k"].dtype == torch.bfloat16
    for n in ("k", "v"):
        ref = np.asarray(want[n]).view(np.uint16).transpose(0, 1, 3, 2, 4)
        assert np.array_equal(got[n].view(torch.int16).numpy().view(
            np.uint16), ref), n
    assert got["pos"].tolist() == [0, 1, 2, 3, 4, -1, -1, -1, -1]
    assert int(got["t"]) == 5 and got["t"].dtype == torch.int32
    back = lm_cache_to_reference(got)
    for n in want:
        assert np.array_equal(back[n], np.asarray(want[n], back[n].dtype)), n


# ------------------------------------------------------------ decode_step
@pytest.mark.parametrize("tie_embeddings", [False, True])
@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_from_a_reference_cache(dtype, qkv_bias,
                                            tie_embeddings):
    """After 6 reference steps, one step of each package from the
    reference's cache: the logits and the new cache (the new slot's K and V
    within the logits' tolerance, every other slot bit-equal)."""
    jcfg, tcfg = _cfgs(dtype, qkv_bias=qkv_bias,
                       tie_embeddings=tie_embeddings)
    jparams, tparams = _models(jcfg, tcfg)
    toks = _tokens(jcfg.vocab, 7, 3).astype(np.int32)   # 7 steps of 3
    cache = JT.init_cache(jcfg, 3, 12)
    for tok in toks[:6]:
        _, cache = _ref_decode(jcfg, jparams, cache, tok)
    tcache = lm_cache_from_reference(jax.device_get(cache), device="cpu")
    want, wcache = _ref_decode(jcfg, jparams, cache, toks[6])
    got, gcache = T.decode_step(tparams, tcache, torch.from_numpy(toks[6]),
                                tcfg)
    assert got.shape == (3, tcfg.vocab) and got.dtype == tcfg.dtype
    _close(dtype, got.float().numpy(), want)
    wcache = jax.device_get(wcache)
    gcache = lm_cache_to_reference(gcache)
    assert np.array_equal(gcache["pos"], np.asarray(wcache["pos"]))
    assert int(gcache["t"]) == int(wcache["t"]) == 7
    for n in ("k", "v"):
        g, w = gcache[n], np.asarray(wcache[n], np.float32)
        assert np.array_equal(np.delete(g, 6, axis=2), np.delete(w, 6, axis=2))
        _close(dtype, g[:, :, 6], w[:, :, 6])


def test_decode_matches_the_reference_forward():
    """Token by token over 20 positions of 2 sequences against the
    reference's ``forward`` (its ``test_decode_matches_forward[full]``)."""
    jcfg, tcfg = _cfgs("float32")
    jparams, tparams = _models(jcfg, tcfg)
    tokens = _tokens(jcfg.vocab, 2, 20)
    want, _ = JT.forward(jparams, jnp.asarray(tokens), jcfg)
    cache = T.init_cache(tcfg, 2, 20, device="cpu")
    outs = []
    for i in range(20):
        logits, cache = T.decode_step(tparams, cache,
                                      torch.from_numpy(tokens[:, i]), tcfg)
        outs.append(logits)
    got = torch.stack(outs, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=0)


def test_decode_at_full_width_matches_the_reference():
    """qwen3-14b's published widths (d 5120, 40 heads over 8 KV heads, hd
    128, d_ff 17408), 2 layers, vocab 4096, float32: 8 decode steps of one
    sequence, each package on its own cache, logits within atol 3e-4."""
    jcfg = dataclasses.replace(jconfigs.get("qwen3-14b").model_cfg,
                               n_layers=2, vocab=4096, dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get("qwen3-14b").model_cfg,
                               n_layers=2, vocab=4096, dtype=torch.float32)
    jparams, tparams = _models(jcfg, tcfg)
    tokens = _tokens(jcfg.vocab, 1, 8)
    jcache = JT.init_cache(jcfg, 1, 8)
    tcache = T.init_cache(tcfg, 1, 8, device="cpu")
    for i in range(8):
        want, jcache = _ref_decode(jcfg, jparams, jcache, tokens[:, i])
        got, tcache = T.decode_step(tparams, tcache,
                                    torch.from_numpy(tokens[:, i]), tcfg)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=0)


def test_decode_updates_the_cache_in_place():
    """The returned cache is the one passed in, its storage kept, and no
    step allocates a block as large as a layer's K (no copy of K or V, no
    second cache; the profiler's memory events)."""
    from torch.profiler import ProfilerActivity, profile

    _, tcfg = _cfgs("float32")
    params = T.init_params(torch.Generator("cpu").manual_seed(1), tcfg,
                           device="cpu")
    cache = T.init_cache(tcfg, 4, 2048, device="cpu")
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    layer_bytes = cache["k"][0].numel() * cache["k"].element_size()
    tokens = torch.from_numpy(_tokens(tcfg.vocab, 2, 4))
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        for tok in tokens:
            _, out = T.decode_step(params, cache, tok, tcfg)
            assert out is cache
    allocs = [e.cpu_memory_usage for e in prof.events()
              if e.cpu_memory_usage > 0]
    assert allocs and max(allocs) < layer_bytes, (max(allocs), layer_bytes)
    assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
    assert int(cache["t"]) == 2
    assert cache["pos"][:3].tolist() == [0, 1, -1]
    assert cache["k"][:, :, :, :2].abs().sum() > 0
    assert not cache["k"][:, :, :, 2:].any()


def test_attn_block_over_a_cache_matches_the_reference():
    """``_attn_block(cache=...)`` with 3 new positions written at slot 6 of
    an 8-slot cache (the reference's ``dynamic_update_slice`` clamps the
    start to 5), and ``_sdpa_dense`` with 3 queries and empty slots."""
    jcfg, tcfg = _cfgs("float32")
    params = _state(jcfg)
    jlp = {k: jnp.asarray(v[0]) for k, v in params["layers"].items()}
    tlp = {k: v[0] for k, v in lm_from_reference(params,
                                                 device="cpu")["layers"].items()}
    rng = np.random.default_rng(11)
    B, S, Skv, Kv, hd = 2, 3, 8, tcfg.n_kv_heads, tcfg.hd
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    ck, cv = [rng.standard_normal((B, Skv, Kv, hd)).astype(np.float32)
              for _ in range(2)]
    kv_pos = np.asarray([0, 1, 2, 3, 4, 5, 6, -1], np.int32)
    q_pos = np.asarray([5, 6, 7], np.int32)
    kv_valid = kv_pos >= 0
    want, (wk, wv) = JT._attn_block(
        jcfg, jlp, 0, jnp.asarray(x), jnp.asarray(q_pos),
        cache=tuple(map(jnp.asarray, (ck, cv, kv_pos, kv_valid)))
        + (jnp.asarray(6, jnp.int32),))
    tk, tv = [torch.from_numpy(c.transpose(0, 2, 1, 3).copy()) for c in
              (ck, cv)]
    got, (gk, gv) = T._attn_block(
        tcfg, tlp, 0, torch.from_numpy(x), torch.from_numpy(q_pos),
        cache=(tk, tv, torch.from_numpy(kv_pos), torch.from_numpy(kv_valid),
               torch.tensor(6)))
    assert gk is tk and gv is tv
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=0)
    for g, w in ((gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                                   atol=5e-5, rtol=0)
    q = rng.standard_normal((B, S, tcfg.n_heads, hd)).astype(np.float32)
    want = JT._sdpa_dense(jcfg, 0, jnp.asarray(q), jnp.asarray(ck),
                          jnp.asarray(cv), jnp.asarray(q_pos),
                          jnp.asarray(kv_pos), jnp.asarray(kv_valid))
    got = T._sdpa_dense(tcfg, 0, torch.from_numpy(q),
                        torch.from_numpy(ck.transpose(0, 2, 1, 3).copy()),
                        torch.from_numpy(cv.transpose(0, 2, 1, 3).copy()),
                        torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                        torch.from_numpy(kv_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen2-7b", "granite-8b",
                                  "mixtral-8x7b", "llama4-scout-17b-16e"])
def test_registered_lm_archs_prefill_and_decode_match_the_reference(arch):
    """Each registered LM's smoke config (qwen2's QKV bias, granite's rope
    theta 1e4, mixtral's window and MoE, llama4's chunks and shared
    expert): prefill of 2 x 48 tokens (2 x 64 for the MoE archs, whose
    64-token groups must divide the tokens) within atol 5e-5, then 6
    decode steps, each package on its own cache, within atol 5e-5."""
    jcfg = jconfigs.get(arch).smoke_cfg
    tcfg = configs.get(arch).smoke_cfg
    jparams, tparams = _models(jcfg, tcfg)
    tokens = _tokens(jcfg.vocab, 2, 64 if jcfg.n_experts else 48)
    want = JT.prefill(jparams, jnp.asarray(tokens), jcfg)
    got = T.prefill(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=0)
    jcache = JT.init_cache(jcfg, 2, 8)
    tcache = T.init_cache(tcfg, 2, 8, device="cpu")
    for i in range(6):
        want, jcache = _ref_decode(jcfg, jparams, jcache, tokens[:, i])
        got, tcache = T.decode_step(tparams, tcache,
                                    torch.from_numpy(tokens[:, i]), tcfg)
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


# ----------------------------------------------------------------- server
def _serve_model():
    """``tests/test_serve.py``'s model in both packages, one state."""
    jcfg = JT.TransformerConfig(n_layers=2, d_model=32, n_heads=4,
                                n_kv_heads=2, d_ff=64, vocab=50,
                                dtype=jnp.float32, moe_group_size=32)
    tcfg = T.TransformerConfig(n_layers=2, d_model=32, n_heads=4,
                               n_kv_heads=2, d_ff=64, vocab=50,
                               dtype=torch.float32, moe_group_size=32)
    jparams = JT.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jparams, lm_from_reference(jax.device_get(jparams),
                                                  device="cpu")


def _serve_both(jcfg, tcfg, jparams, tparams, requests, slots, max_len,
                eos_id=-1):
    """The same requests through both servers: (reference outputs, port
    outputs, reference stats, port stats)."""
    out = []
    for srv_mod, cfg, params in ((JS, jcfg, jparams), (TS, tcfg, tparams)):
        srv = srv_mod.BatchedServer(params, cfg, slots=slots,
                                    max_len=max_len, eos_id=eos_id)
        if srv_mod is JS:
            # The reference's ``_fill_slots`` hands ``jnp.asarray`` of its
            # token buffer to an asynchronous dispatch and then writes the
            # buffer, so a late read sees other slots' later tokens and its
            # outputs vary from run to run (ROADMAP.md §C).  Waiting for
            # each call fixes the order its code states; its arithmetic is
            # unchanged.
            decode = srv._decode
            srv._decode = lambda p, c, t, f=decode: jax.block_until_ready(
                f(p, c, t))
        reqs = [srv_mod.Request(prompt=np.asarray(p), max_new_tokens=n)
                for p, n in requests]
        for r in reqs:
            srv.submit(r)
        stats = srv.run_to_completion()
        out.append(([r.out for r in reqs], stats))
    (want, wstats), (got, gstats) = out
    return want, got, wstats, gstats


def _same_stats(wstats, gstats):
    assert {k: v for k, v in gstats.items() if k != "wall"} == {
        k: v for k, v in wstats.items() if k != "wall"}
    assert gstats["wall"] > 0


def test_server_matches_the_reference_server():
    """``test_serve.py``'s 7 requests over 4 slots (the refill path)."""
    jcfg, tcfg, jparams, tparams = _serve_model()
    requests = [([1 + i, 2, 3], 5) for i in range(7)]
    want, got, wstats, gstats = _serve_both(jcfg, tcfg, jparams, tparams,
                                            requests, slots=4, max_len=64)
    assert got == want
    assert all(len(o) == 5 for o in got)
    _same_stats(wstats, gstats)
    assert gstats["decoded_tokens"] == 35 and gstats["steps"] >= 10


def test_server_eos_frees_a_slot_as_the_reference():
    """EOS is the greedy first token of a request: its request stops after
    one token, frees the slot, and the next request takes it."""
    jcfg, tcfg, jparams, tparams = _serve_model()
    want, got, _, _ = _serve_both(jcfg, tcfg, jparams, tparams,
                                  [([7, 3], 1)], slots=1, max_len=32)
    eos = got[0][0]
    assert got == want
    requests = [([7, 3], 10), ([4, 9, 1], 6), ([7, 3], 10)]
    want, got, wstats, gstats = _serve_both(jcfg, tcfg, jparams, tparams,
                                            requests, slots=1, max_len=64,
                                            eos_id=eos)
    assert got == want
    assert got[0] == [eos]
    _same_stats(wstats, gstats)


def test_server_one_slot_matches_a_manual_decode_loop():
    """A first request alone in one slot equals ``decode_step`` by hand and
    the reference's server (``test_server_greedy_matches_manual_decode``)."""
    jcfg, tcfg, jparams, tparams = _serve_model()
    prompt = [5, 9, 11]
    want, got, _, _ = _serve_both(jcfg, tcfg, jparams, tparams,
                                  [(prompt, 4)], slots=1, max_len=32)
    cache = T.init_cache(tcfg, 1, 32, device="cpu")
    for tok in prompt:
        logits, cache = T.decode_step(tparams, cache, torch.tensor([tok]),
                                      tcfg)
    outs = []
    for _ in range(4):
        nxt = int(torch.argmax(logits[0]))
        outs.append(nxt)
        logits, cache = T.decode_step(tparams, cache, torch.tensor([nxt]),
                                      tcfg)
    assert got[0] == outs == want[0]


def test_server_matches_the_reference_on_a_seeded_sequence():
    """12 requests with prompts of 2 to 9 tokens and 3 to 8 new tokens over
    3 slots (slots free at different steps), on qwen3's smoke config:
    token for token, and the same stats."""
    jcfg, tcfg = _cfgs("float32")
    jparams, tparams = _models(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(12)
    requests = [(rng.integers(0, jcfg.vocab, rng.integers(2, 10)).tolist(),
                 int(rng.integers(3, 9))) for _ in range(12)]
    want, got, wstats, gstats = _serve_both(jcfg, tcfg, jparams, tparams,
                                            requests, slots=3, max_len=256)
    assert got == want
    assert [len(o) for o in got] == [n for _, n in requests]
    _same_stats(wstats, gstats)


def test_server_keeps_one_cache_on_the_parameters_device():
    _, tcfg, _, tparams = _serve_model()
    srv = TS.BatchedServer(tparams, tcfg, slots=2, max_len=16)
    ptr = srv.cache["k"].data_ptr()
    srv.submit(TS.Request(prompt=np.asarray([3, 4, 5]), max_new_tokens=3))
    srv.run_to_completion()
    assert srv.cache["k"].device == tparams["embed"].device
    assert srv.cache["k"].data_ptr() == ptr
    assert isinstance(srv.pending, collections.deque)


# ------------------------------------------------------------ entry points
def test_serve_lm_launcher_at_smoke_size(capsys):
    stats = serve_lm.main(["--arch", "qwen3-14b", "--requests", "12",
                           "--slots", "4", "--max-new", "24", "--device",
                           "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "arch=qwen3-14b (smoke config), slots=4"
    assert lines[1].startswith("decoded 288 tokens in ")
    assert lines[1].endswith(f"tok/s, {stats['steps']} decode steps)")
    assert stats["decoded_tokens"] == 288
    with pytest.raises(ValueError, match="not an LM"):
        serve_lm.main(["--arch", "baidu-ctr", "--device", "cpu"])


def test_decode_entry_points_raise_for_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("float32")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        T.init_cache(tcfg, 1, 8)
    on_card = {"embed": types.SimpleNamespace(device=torch.device("cuda"))}
    with pytest.raises(RuntimeError, match="device='cuda'"):
        TS.BatchedServer(on_card, tcfg, slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        serve_lm.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cuda'"):
        lm_cache_from_reference(
            {"k": np.zeros((1, 1, 2, 1, 8), np.float32),
             "v": np.zeros((1, 1, 2, 1, 8), np.float32),
             "pos": np.full(2, -1, np.int32), "t": np.int32(0)})


@pytest.mark.parametrize("field,value", [
    ("n_experts", 8), ("attn_window", 64), ("attn_chunk", 64),
])
def test_decode_raises_naming_a10d(field, value):
    """Decode with MoE or a windowed or chunked mask runs (A10d's serving
    path; a window's cache is its ring), and so does training such a
    config (A10d training): ``build_trainer`` builds a ``DenseTrainer``
    over it that takes a step with a finite loss."""
    from repro_torch.runtime.factory import build_trainer
    from repro_torch.runtime.trainer import TrainerConfig

    _, tcfg = _cfgs("float32")
    bad = dataclasses.replace(tcfg, **{field: value})
    cache = T.init_cache(bad, 1, 80, device="cpu")
    assert cache["k"].shape[3] == T.cache_len(bad, 80)
    params = T.init_params(torch.Generator("cpu").manual_seed(0), bad,
                           device="cpu")
    logits, cache = T.decode_step(params, cache,
                                  torch.zeros(1, dtype=torch.int32), bad)
    assert logits.shape == (1, bad.vocab) and int(cache["t"]) == 1
    tr = build_trainer("qwen3-14b", TrainerConfig(), model_cfg=bad,
                       device="cpu")
    toks = np.random.default_rng(3).integers(0, bad.vocab, (2, 33))
    loss = tr.train_step({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(loss))
