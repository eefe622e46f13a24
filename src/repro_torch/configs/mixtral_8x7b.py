"""mixtral-8x7b [MoE LM] — 32L d4096 32H (GQA kv=8) dff14336 vocab32000,
8 experts top-2, sliding-window attention (W=4096).  [arXiv:2401.04088; hf]

The same numbers as ``repro/configs/mixtral_8x7b.py``.  The sliding window
makes long_500k runnable: the decode KV cache is a W-slot ring buffer.  At
full width the weights are 46.70e9 parameters, 93.4 GB in bfloat16 (2.90 GB
a layer), more than one 80 GB card holds.
"""

import torch

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

MODEL = TransformerConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128,
    attn_window=4096, n_experts=8, top_k=2, capacity_factor=1.25,
    router_aux_coef=0.01, rope_theta=1e6, dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="mixtral-8x7b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=32,
    attn_window=16, n_experts=4, top_k=2,
    router_aux_coef=0.01, dtype=torch.float32, moe_group_size=64,
)

ARCH = ArchSpec(
    name="mixtral-8x7b", family="lm", model_cfg=MODEL, smoke_cfg=SMOKE,
    shapes=lm_shapes(), source="arXiv:2401.04088; hf",
)
