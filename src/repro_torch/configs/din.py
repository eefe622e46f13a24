"""din [recsys] — embed_dim=18, seq_len=100, attn MLP 80-40, MLP 200-80,
target attention.  [arXiv:1706.06978; paper]

The same numbers as ``repro/configs/din.py``.  The item table (2 M rows
x 18 f32, 144 MB, and as much again of AdaGrad accumulator) fits one
card whole.
"""

from repro_torch.configs import ArchSpec, recsys_shapes
from repro_torch.models.recsys import DINConfig

MODEL = DINConfig(
    name="din", embed_dim=18, seq_len=100,
    attn_mlp=(80, 40), mlp=(200, 80), item_vocab=2_000_000, gru_dim=0,
)

SMOKE = DINConfig(
    name="din-smoke", embed_dim=8, seq_len=20,
    attn_mlp=(16, 8), mlp=(32, 16), item_vocab=500, gru_dim=0,
)

ARCH = ArchSpec(
    name="din", family="recsys", model_cfg=MODEL, smoke_cfg=SMOKE,
    shapes=recsys_shapes(), source="arXiv:1706.06978; paper",
)
