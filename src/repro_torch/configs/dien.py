"""dien [recsys] — embed_dim=18, seq_len=100, GRU(108) + AUGRU interest
evolution, attn MLP 80-40 (hidden-space), MLP 200-80.
[arXiv:1809.03672; unverified]

The same numbers as ``repro/configs/dien.py``; DIN's item table.
"""

from repro_torch.configs import ArchSpec, recsys_shapes
from repro_torch.models.recsys import DINConfig

MODEL = DINConfig(
    name="dien", embed_dim=18, seq_len=100,
    attn_mlp=(80, 40), mlp=(200, 80), item_vocab=2_000_000, gru_dim=108,
)

SMOKE = DINConfig(
    name="dien-smoke", embed_dim=8, seq_len=20,
    attn_mlp=(16, 8), mlp=(32, 16), item_vocab=500, gru_dim=12,
)

ARCH = ArchSpec(
    name="dien", family="recsys", model_cfg=MODEL, smoke_cfg=SMOKE,
    shapes=recsys_shapes(), source="arXiv:1809.03672; unverified",
)
