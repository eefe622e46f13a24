"""granite-8b [dense LM] — 36L d4096 32H (GQA kv=8) dff14336 vocab49152,
llama-arch, code model.  [arXiv:2405.04324; hf]

The same numbers as ``repro/configs/granite_8b.py``.  Full attention and a
dense FFN, so the port's prefill and decode run it as they run qwen3-14b.
"""

import dataclasses

import torch

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

MODEL = TransformerConfig(
    name="granite-8b",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, head_dim=128,
    rope_theta=1e4, dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="granite-8b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=32,
    rope_theta=1e4, dtype=torch.float32, moe_group_size=128,
)

shapes = lm_shapes()
shapes["long_500k"] = dataclasses.replace(
    shapes["long_500k"],
    skip="pure full-attention arch: 500k decode requires sub-quadratic attention (DESIGN.md §5)",
)

ARCH = ArchSpec(
    name="granite-8b", family="lm", model_cfg=MODEL, smoke_cfg=SMOKE,
    shapes=shapes, source="arXiv:2405.04324; hf",
)
