"""two-tower-retrieval [recsys] — embed_dim=256, tower MLP 1024-512-256,
dot interaction, sampled softmax retrieval.  [RecSys'19 (YouTube); unverified]

The same numbers as ``repro/configs/two_tower.py``.  The item table (5 M
rows x 256 f32, 5.12 GB, and as much again of AdaGrad accumulator) fits
one card whole.
"""

from repro_torch.configs import ArchSpec, recsys_shapes
from repro_torch.models.recsys import TwoTowerConfig

MODEL = TwoTowerConfig(
    name="two-tower-retrieval", embed_dim=256,
    tower_mlp=(1024, 512, 256), user_hist_len=50, item_vocab=5_000_000,
)

SMOKE = TwoTowerConfig(
    name="two-tower-smoke", embed_dim=16,
    tower_mlp=(32, 16), user_hist_len=10, item_vocab=500,
)

ARCH = ArchSpec(
    name="two-tower-retrieval", family="recsys", model_cfg=MODEL,
    smoke_cfg=SMOKE, shapes=recsys_shapes(),
    source="RecSys'19 (YouTube); unverified",
)
