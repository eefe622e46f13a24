"""dlrm-mlperf [recsys] — MLPerf DLRM benchmark config (Criteo 1TB):
13 dense + 26 sparse features, embed_dim=128, bot 13-512-256-128,
top 1024-1024-512-256-1, dot interaction.  [arXiv:1906.00091; paper]

The same numbers as ``repro/configs/dlrm_mlperf.py``.  The full tables
(187,767,399 rows, 96.1 GB plus as much again of AdaGrad accumulator) do
not fit one card; a run on one cuts each table's rows (see PERF.md).
"""

from repro_torch.configs import ArchSpec, recsys_shapes
from repro_torch.models.recsys import CRITEO_ROWS, DLRMConfig

MODEL = DLRMConfig(
    name="dlrm-mlperf",
    n_dense=13, n_sparse=26, embed_dim=128,
    bot_mlp=(13, 512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    rows=tuple(CRITEO_ROWS),
)

SMOKE = DLRMConfig(
    name="dlrm-smoke",
    n_dense=13, n_sparse=26, embed_dim=16,
    bot_mlp=(13, 32, 16),
    top_mlp=(64, 32, 1),
    rows=tuple([200] * 26),
)

ARCH = ArchSpec(
    name="dlrm-mlperf", family="recsys", model_cfg=MODEL, smoke_cfg=SMOKE,
    shapes=recsys_shapes(), source="arXiv:1906.00091; paper",
)
