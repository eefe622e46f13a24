"""qwen3-14b [dense LM] — 40L d5120 40H (GQA kv=8) dff17408 vocab151936,
qk-norm, GQA.  [hf:Qwen/Qwen3-14B; hf]

The same numbers as ``repro/configs/qwen3_14b.py``.  That file's docstring
and ``source`` name ``hf:Qwen/Qwen3-8B``, but its values are Qwen3-14B's
(40 layers, hidden 5120, 40 heads, 8 KV heads, intermediate 17408, vocab
151936, head_dim 128, qk-norm, rope theta 1e6, untied embeddings; Qwen3-8B
has 36 layers, hidden 4096, 32 heads and intermediate 12288), so this copy
names the 14B model.  At full width the weights are 14.77e9 parameters,
29.5 GB in bfloat16.
"""

import dataclasses

import torch

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

MODEL = TransformerConfig(
    name="qwen3-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6, dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="qwen3-14b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=16,
    qk_norm=True, rope_theta=1e6, dtype=torch.float32, moe_group_size=128,
)

shapes = lm_shapes()
shapes["long_500k"] = dataclasses.replace(
    shapes["long_500k"],
    skip="pure full-attention arch: 500k decode requires sub-quadratic attention (DESIGN.md §5)",
)

ARCH = ArchSpec(
    name="qwen3-14b", family="lm", model_cfg=MODEL, smoke_cfg=SMOKE,
    shapes=shapes, source="hf:Qwen/Qwen3-14B; hf",
)
