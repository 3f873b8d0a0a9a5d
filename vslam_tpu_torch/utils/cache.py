"""Persistent cache of the port's compiled programs.

Port of `vslam_tpu/utils/cache.py`, which turns on JAX's persistent
compilation cache. The only programs the port compiles are its CUDA
kernels (`ops.cuda_matching.build`, `nvcc` into a shared library); this
module sets the directory they are built into and loaded from, so that a
later process (a mesh worker, the next run) loads the library instead of
running `nvcc` again. The default is `vslam_tpu_torch/_build/`.
"""

from __future__ import annotations

import os

from vslam_tpu_torch.ops import cuda_matching

DEFAULT = cuda_matching.BUILD_DIR


def enable_persistent_cache(path: str | None = None) -> str:
    """Build and load the kernels under `path` (default `DEFAULT`);
    returns the directory. Safe to call more than once; a library already
    loaded in this process stays loaded."""
    path = os.path.abspath(path or DEFAULT)
    os.makedirs(path, exist_ok=True)
    cuda_matching.set_build_dir(path)
    return path


def cache_dir() -> str:
    """The directory the kernels are built into and loaded from."""
    return cuda_matching.BUILD_DIR
