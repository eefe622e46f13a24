"""Architecture registry of the port (``repro/configs/__init__.py``).

``get(name)`` returns an arch's ``ArchSpec``.  Only the archs the port has
reached are registered; ``get`` raises ``KeyError`` for the others.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional

_MODULES = {
    "baidu-ctr": "repro_torch.configs.baidu_ctr",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "llama4-scout-17b-16e": "repro_torch.configs.llama4_scout",
    "din": "repro_torch.configs.din",
    "dien": "repro_torch.configs.dien",
    "two-tower-retrieval": "repro_torch.configs.two_tower",
    "gin-tu": "repro_torch.configs.gin_tu",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (arch x input-shape) cell."""
    name: str
    kind: str                 # train | prefill | decode | serve | retrieval
    dims: Dict[str, int]
    skip: Optional[str] = None  # reason string if inapplicable


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str               # lm | gnn | recsys
    model_cfg: Any            # full-size model config
    smoke_cfg: Any            # reduced config (CPU tests)
    shapes: Dict[str, ShapeSpec]
    source: str = ""          # provenance tag


def get(name: str) -> ArchSpec:
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not in the port yet; ported: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).ARCH


def lm_shapes() -> Dict[str, ShapeSpec]:
    """The LM archs' cells (``repro/configs/__init__.py``)."""
    return {
        "train_4k": ShapeSpec("train_4k", "train", {"seq": 4096, "batch": 256}),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
        "decode_32k": ShapeSpec("decode_32k", "decode", {"seq": 32768, "batch": 128}),
        "long_500k": ShapeSpec("long_500k", "decode", {"seq": 524288, "batch": 1}),
    }


def recsys_shapes() -> Dict[str, ShapeSpec]:
    """The recsys archs' cells (``repro/configs/__init__.py``)."""
    return {
        "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
        "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
        "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
        "retrieval_cand": ShapeSpec(
            "retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}
        ),
    }
