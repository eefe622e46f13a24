"""The roundings of kernel 9b's bfloat16 path (flash attention's backward
on the tensor cores, ``csrc/flash_attention.cu``), pinned on the CPU.

The kernel itself runs only on the card (``test_torch_gpu.py``).  Here a
plain PyTorch model of its arithmetic, kept in this test and not in the
package, stands in for it:
- q, k, v and dO in bfloat16, as the kernel stages them; every product of
  two of them is exact in float32, and the sums are float32;
- s = (q . k) / sqrt(hd), P = exp(s - lse) (0 where masked), dP = dO . v,
  D = rowsum(dO o) from the bfloat16 output o, dS = P (dP - D);
- P and dS rounded once to bfloat16, where the kernel rounds them into the
  A operands of dV += P^T dO, dK += dS^T Q and dQ += dS K;
- dK and dQ times 1/sqrt(hd) after the sums, each gradient rounded once.
Summation orders differ from the kernel's, so the model and the kernel
agree to a bf16 ulp of a gradient, not bit for bit.

Held, on inputs drawn from a numpy seed:
- against ``ref.flash_attention_backward_ref`` (the plain vjp, float32
  inside), on the bfloat16 cases of the card's
  ``test_cuda_flash_attention_backward_matches_plain_vjp`` that fit the
  CPU: every gradient within ``FLASH_BWD_TOL`` (2e-2) of its largest
  magnitude, or of 1 where that is below 1 (the card test's measure).
  The model stays within 7.4e-3: P and dS rounded once take 2^-9 of each
  term, which the sums average down, and the gradient's own rounding
  takes 2^-9;
- against XLA's vjp of the reference's ``_sdpa_dense`` in bfloat16 (GQA,
  causal), within 2e-2 of each gradient's largest magnitude: XLA rounds
  the forward's P to bfloat16 before P V and rounds dP, dS and each
  product's output to bfloat16 at other places than the kernel; the two
  stay within 5.3e-3 at this shape.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch.kernels import ref as tref

# every gradient within this share of its largest magnitude (or of 1):
# the card test's bfloat16 tolerance, unchanged
FLASH_BWD_TOL = 2e-2


def _inputs(B, S, H, Kv, hd, seed):
    """q, k, v, dO in bfloat16 from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16)
            for shape in ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd),
                          (B, S, H, hd))]


def _model_backward(q, k, v, dout, causal):
    """``(dq, dk, dv)`` in bfloat16 by the kernel's arithmetic (the
    module's docstring), from the forward's bfloat16 output and float32
    row log-sum-exp as kernel 9 gives them."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    scale = 1.0 / math.sqrt(hd)
    out = tref.flash_attention_ref(q, k, v, causal)
    lse = tref.flash_attention_lse_ref(q, k, causal).reshape(B, Kv, G, S)
    qf = q.float().reshape(B, S, Kv, G, hd)
    df = dout.float().reshape(B, S, Kv, G, hd)
    kf, vf = k.float(), v.float()
    p = torch.exp(torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
                  - lse[..., None])
    if causal:
        pos = torch.arange(S)
        p = p.masked_fill(pos[None, :] > pos[:, None], 0.0)
    dp = torch.einsum("bskgd,btkd->bkgst", df, vf)
    delta = (df * out.float().reshape(B, S, Kv, G, hd)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    p16 = p.to(torch.bfloat16).float()
    ds16 = ds.to(torch.bfloat16).float()
    dv = torch.einsum("bkgst,bskgd->btkd", p16, df)
    dk = torch.einsum("bkgst,bskgd->btkd", ds16, qf) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds16, kf).reshape(B, S, H, hd)
    return tuple(x.to(torch.bfloat16) for x in (dq * scale, dk, dv))


def _worst(got, want):
    """Each gradient's max |got - want| over max(max |want|, 1)."""
    return [(a.float() - w.float()).abs().max().item()
            / max(w.float().abs().max().item(), 1.0)
            for a, w in zip(got, want)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kv,hd", [
    (1, 1000, 8, 2, 128), (2, 63, 4, 4, 64), (1, 130, 10, 2, 40),
    (1, 17, 8, 1, 256), (1, 1, 4, 2, 64), (1, 512, 40, 8, 128),
    (1, 127, 40, 8, 128), (1, 128, 40, 8, 128), (1, 129, 40, 8, 128),
    (1, 129, 8, 8, 128), (1, 200, 16, 2, 64), (2, 129, 4, 2, 40),
    (1, 257, 4, 1, 256),
])
def test_bf16_rounding_model_matches_plain_vjp(B, S, H, Kv, hd, causal):
    q, k, v, dout = _inputs(B, S, H, Kv, hd, seed=S + hd + 1)
    got = _model_backward(q, k, v, dout, causal)
    want = tref.flash_attention_backward_ref(q, k, v, dout, causal)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
    worst = _worst(got, want)
    assert max(worst) <= FLASH_BWD_TOL, worst


def test_bf16_rounding_model_matches_reference_attention_vjp():
    B, S, H, Kv, hd = 2, 40, 8, 2, 32
    q, k, v, dout = _inputs(B, S, H, Kv, hd, seed=7)
    jcfg = jconfigs.get("qwen3-14b").smoke_cfg
    pos = jnp.arange(S, dtype=jnp.int32)

    @jax.jit
    def vjp(a, b, c, g):
        _, f = jax.vjp(lambda a, b, c: JT._sdpa_dense(jcfg, 0, a, b, c, pos,
                                                      pos), a, b, c)
        return f(g)

    want = vjp(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                 for x in (q, k, v, dout)))
    want = [torch.from_numpy(np.array(w.astype(jnp.float32)))
            for w in want]
    got = _model_backward(q, k, v, dout, True)
    worst = _worst(got, want)
    assert max(worst) <= FLASH_BWD_TOL, worst
