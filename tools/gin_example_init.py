#!/usr/bin/env python3
"""Write the initial GIN weights of the reference's GIN example.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/gin_example_init.py

``examples/train_gin.py`` starts both of its regimes from
``repro.models.gin.init_params(jax.random.key(0), cfg)`` with gin-tu's
smoke config at ``d_in`` 32 and 5 classes; its accuracy bars hold from
that draw (other draws diverge under its lr 3e-3: ROADMAP.md §C).  This
writes those weights, leaf by leaf under the checkpoint's leaf names, to
``tests/fixtures/gin_example_init.npz``, so that the port's runs of the
example (``tests/test_torch_gin.py`` on the CPU, ``chip_smoke.py`` on the
card, neither of which may import JAX there) start from the same state.
``tests/test_torch_gin.py`` checks the file against a fresh draw.
"""

import dataclasses
import pathlib

import jax
import numpy as np

from repro import configs
from repro.checkpoint.ckpt import _flatten_with_names
from repro.models import gin as G

OUT = (pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures"
       / "gin_example_init.npz")


def reference_init():
    cfg = dataclasses.replace(configs.get("gin-tu").smoke_cfg, d_in=32,
                              n_classes=5)
    named, _ = _flatten_with_names(jax.device_get(
        G.init_params(jax.random.key(0), cfg)))
    return {k: np.asarray(v) for k, v in named.items()}


if __name__ == "__main__":
    np.savez(OUT, **reference_init())
    print(f"wrote {OUT}")
