"""baidu-ctr — the paper's own model (§2.1 Fig. 2): ~1e11-dim multi-hot
sparse input (~100 nnz/instance) -> 64-d embedding bags per field -> field
self-attention -> MLP.  The full config holds 2e9 rows x 64 f32 (512 GB of
table + 512 GB of AdaGrad accumulator); one card holds a cut of its rows
(see PERF.md).  The smoke config is CPU-size.

The same numbers as ``repro/configs/baidu_ctr.py``.
"""

from repro_torch.configs import ArchSpec, ShapeSpec
from repro_torch.models.recsys import CTRConfig

MODEL = CTRConfig(
    name="baidu-ctr", rows=2_000_000_000, embed_dim=64, n_fields=40,
    nnz_per_instance=100, mlp=(512, 256, 1),
)

SMOKE = CTRConfig(
    name="baidu-ctr-smoke", rows=20_000, embed_dim=16, n_fields=8,
    nnz_per_instance=20, mlp=(32, 1), attn_heads=2,
)

SHAPES = {
    "train_mb1k": ShapeSpec("train_mb1k", "train", {"batch": 1024}),
    "train_mb8k": ShapeSpec("train_mb8k", "train", {"batch": 8192}),
    "serve_online": ShapeSpec("serve_online", "serve", {"batch": 1024}),
}

ARCH = ArchSpec(
    name="baidu-ctr", family="recsys", model_cfg=MODEL, smoke_cfg=SMOKE,
    shapes=SHAPES, source="the paper (Zhao et al. 2022)",
)
