"""llama4-scout-17b-16e [MoE LM] — 48L d5120 40H (GQA kv=8) dff8192
vocab202048, MoE 16 experts top-1 + shared expert, chunked local attention
(8192) with every-4th-layer global (iRoPE).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

The same numbers as ``repro/configs/llama4_scout.py``.  Chunked attention
makes long_500k runnable (local layers attend within an 8k chunk; global
layers use the full cache).  Like the reference, every layer applies RoPE:
the published model's global layers use none (ROADMAP.md §C).  At full
width the weights are 107.7e9 parameters, 215 GB in bfloat16 (4.40 GB a
layer, 4.14 GB of embedding and head).
"""

import torch

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

MODEL = TransformerConfig(
    name="llama4-scout-17b-16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    attn_chunk=8192, global_every=4,
    n_experts=16, top_k=1, capacity_factor=1.25, shared_expert=True,
    router_aux_coef=0.01, rope_theta=5e5, dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="llama4-scout-smoke",
    n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab=512, head_dim=16,
    attn_chunk=16, global_every=4,
    n_experts=4, top_k=1, shared_expert=True,
    router_aux_coef=0.01, dtype=torch.float32, moe_group_size=64,
)

ARCH = ArchSpec(
    name="llama4-scout-17b-16e", family="lm", model_cfg=MODEL,
    smoke_cfg=SMOKE, shapes=lm_shapes(),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
