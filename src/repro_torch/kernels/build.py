"""The one build of the hand-written CUDA kernels.

All sources under ``csrc/`` go into one ``torch.utils.cpp_extension.load``
call, into ``build/torch_kernels/`` at the root of the checkout
(gitignored).  Only ``bindings.cpp`` includes PyTorch's headers; the
kernels (``*.cu``) see plain pointers, so ``nvcc`` compiles them in
seconds.  The build happens at first use, never on import: the CPU tests
import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import os
import pathlib

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_REPO = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build" / "torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
SOURCES = ("bindings.cpp", "embedding_bag.cu", "sparse_adagrad.cu")

_ext = None


def extension():
    """The compiled kernels (built on first call; ``load`` reuses an
    unchanged build)."""
    global _ext
    if _ext is None:
        from torch.utils.cpp_extension import load

        os.makedirs(BUILD_DIR, exist_ok=True)
        _ext = load(
            name="repro_torch_kernels",
            sources=[str(_CSRC / s) for s in SOURCES],
            build_directory=str(BUILD_DIR),
            extra_cflags=["-O3"],
            extra_cuda_cflags=CUDA_FLAGS,
            verbose=False,
        )
    return _ext
