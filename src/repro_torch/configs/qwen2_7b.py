"""qwen2-7b [dense LM] — 28L d3584 28H (GQA kv=4) dff18944 vocab152064,
GQA + QKV bias.  [arXiv:2407.10671; hf]

The same numbers as ``repro/configs/qwen2_7b.py``.  Full attention and a
dense FFN, so the port's prefill and decode run it as they run qwen3-14b;
its QKV bias goes through ``_qkv``.
"""

import dataclasses

import torch

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

MODEL = TransformerConfig(
    name="qwen2-7b",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6, dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="qwen2-7b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=32,
    qkv_bias=True, dtype=torch.float32, moe_group_size=128,
)

shapes = lm_shapes()
shapes["long_500k"] = dataclasses.replace(
    shapes["long_500k"],
    skip="pure full-attention arch: 500k decode requires sub-quadratic attention (DESIGN.md §5)",
)

ARCH = ArchSpec(
    name="qwen2-7b", family="lm", model_cfg=MODEL, smoke_cfg=SMOKE,
    shapes=shapes, source="arXiv:2407.10671; hf",
)
