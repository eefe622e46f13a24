"""The one build of the hand-written CUDA kernels.

All sources under ``csrc/`` go into one ``torch.utils.cpp_extension.load``
call, into ``build/torch_kernels/`` at the root of the checkout
(gitignored), whose ``ninja`` compiles them side by side.  The kernels
(``*.cu``) see plain pointers, so ``nvcc`` compiles them without PyTorch's
headers.  Their wrappers (``bind_*.cpp``, declared in ``bindings.h``)
include ATen's tensor alone, and only the module (``bindings.cpp``) the
Python binding's headers; none includes ``<torch/extension.h>``, whose
C++ frontend took one source most of a minute to compile.  The build
happens at first use, never on import: the CPU tests import every module
on machines without ``nvcc``.
"""

from __future__ import annotations

import os
import pathlib

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_REPO = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build" / "torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
# The shared C++ runtime, named before the compiler's own ``-lstdc++``:
# where that resolves to the static archive, it copies the runtime into the
# module, and the copy's stream and locale state is not the process's, so
# building the message of a failed ``TORCH_CHECK`` crashes instead of
# raising.
LDFLAGS = ["-l:libstdc++.so.6"]
SOURCES = ("bindings.cpp", "bind_embedding_bag.cpp", "bind_sparse.cpp",
           "bind_dense.cpp", "embedding_bag.cu", "sparse_adagrad.cu",
           "hash_map.cu", "fused_adam.cu", "dot_interaction.cu",
           "flash_attention.cu", "flash_attention_backward.cu")

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
            extra_ldflags=LDFLAGS,
            verbose=False,
        )
    return _ext
