"""Wrappers of the hand-written CUDA matching kernels (`csrc/matching.cu`).

The kernels replace the three Pallas TPU kernels of the JAX package:

  radius_match          <- vslam_tpu/ops/pallas_matching.py:_radius_kernel
  radius_match_batched  <- vslam_tpu/ops/pallas_matching.py:_radius_kernel_batched
  top2_match            <- vslam_tpu/ops/pallas_matching.py:_match_kernel

`radius_match` is the B = 1 case of the batched radius kernel's device
code; each wrapper keeps its own launch count.

The source is compiled with `nvcc` for `sm_90a` into a shared library
with a plain C interface under `vslam_tpu_torch/_build/` at first use and
loaded with ctypes. Each wrapper checks device, dtype, shape and
contiguity, allocates outputs and scratch with `torch.empty`, launches on
the current stream, raises if the C function returns a CUDA error, and
adds one to its launch count. The wrappers take CUDA tensors only: the
plain versions live in `ops.matching`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "matching.cu")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIBRARY = os.path.join(BUILD_DIR, "libvslam_matching.so")

# Launch counts, one per kernel wrapper (a wrapper adds one each time it
# launches its kernel, and nowhere else).
LAUNCHES = {"radius_match": 0, "radius_match_batched": 0, "top2_match": 0}

_lib = None
_lock = threading.Lock()


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA matching kernels cannot be built")


def build(force: bool = False) -> str:
    """Compile `csrc/matching.cu` into the shared library (if missing or
    older than the source). Returns the library path."""
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = LIBRARY + f".{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, SOURCE,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    with open(os.path.join(BUILD_DIR, "ptxas.log"), "w") as f:
        f.write(proc.stderr)
    return LIBRARY


def _load():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                lib.vslam_radius_match.argtypes = [
                    P, P, P, I, P, P, P, I, I, I, F, F, P, P, P, P, P, P]
                lib.vslam_radius_match.restype = I
                lib.vslam_top2_num_blocks.argtypes = [I]
                lib.vslam_top2_num_blocks.restype = I
                lib.vslam_top2_match.argtypes = [P, P, I, P, I, I, P, P, P, P, P, P, P]
                lib.vslam_top2_match.restype = I
                _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError {err}")


def _radius_launch(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db, radius_px, desc_thresh):
    """Checks (B, K, D) / (B, M, D) inputs and launches the radius kernel
    over B members. Returns (mp_idx (B, K), kp_ok (B, K), dist (B, K),
    min_pix_d2 (B, M))."""
    B, K, D = desc_q.shape
    M = desc_db.shape[1]
    dev = desc_db.device
    if D % 16:
        raise ValueError(f"descriptor width {D} is not a multiple of 16")
    _check(desc_q, "desc_q", torch.bfloat16, (B, K, D), dev)
    _check(uv_q, "uv_q", torch.float32, (B, K, 2), dev)
    _check(valid_q, "valid_q", torch.bool, (B, K), dev)
    _check(desc_db, "desc_db", torch.bfloat16, (B, M, D), dev)
    _check(uv_db, "uv_db", torch.float32, (B, M, 2), dev)
    _check(valid_db, "valid_db", torch.bool, (B, M), dev)
    lib = _load()
    claim = torch.empty((B, K), dtype=torch.int64, device=dev)
    mp_idx = torch.empty((B, K), dtype=torch.int32, device=dev)
    kp_ok = torch.empty((B, K), dtype=torch.bool, device=dev)
    dist = torch.empty((B, K), dtype=torch.float32, device=dev)
    min_pix_d2 = torch.empty((B, M), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vslam_radius_match(
        desc_q.data_ptr(), uv_q.data_ptr(), valid_q.data_ptr(), K,
        desc_db.data_ptr(), uv_db.data_ptr(), valid_db.data_ptr(), M, D, B,
        float(radius_px) * float(radius_px), float(desc_thresh),
        claim.data_ptr(), mp_idx.data_ptr(), kp_ok.data_ptr(), dist.data_ptr(),
        min_pix_d2.data_ptr(), stream,
    )
    _raise_on(err, "radius_match kernel")
    return mp_idx, kp_ok, dist, min_pix_d2


def radius_match(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db, radius_px, desc_thresh):
    """Fused local-map radius matcher on the card. desc_q (K, D) bf16,
    uv_q (K, 2) f32, valid_q (K,) bool; desc_db (M, D) bf16, uv_db (M, 2)
    f32, valid_db (M,) bool; D a multiple of 16. Returns (mp_idx (K,)
    int32, kp_ok (K,) bool, dist (K,) f32, min_pix_d2 (M,) f32)."""
    for name, t, nd in (("desc_q", desc_q, 2), ("desc_db", desc_db, 2)):
        if t.dim() != nd:
            raise ValueError(f"{name}: expected {nd} dimensions, got {tuple(t.shape)}")
    out = _radius_launch(*(x[None] for x in (desc_q, uv_q, valid_q, desc_db, uv_db, valid_db)),
                         radius_px, desc_thresh)
    LAUNCHES["radius_match"] += 1
    return tuple(x[0] for x in out)


def radius_match_batched(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db, radius_px,
                         desc_thresh):
    """`radius_match` for B members in one launch: desc_q (B, K, D), uv_q
    (B, K, 2), valid_q (B, K); desc_db (B, M, D), uv_db (B, M, 2),
    valid_db (B, M). Returns (mp_idx (B, K), kp_ok (B, K), dist (B, K),
    min_pix_d2 (B, M))."""
    for name, t in (("desc_q", desc_q), ("desc_db", desc_db)):
        if t.dim() != 3:
            raise ValueError(f"{name}: expected (B, n, D), got {tuple(t.shape)}")
    out = _radius_launch(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db, radius_px, desc_thresh)
    LAUNCHES["radius_match_batched"] += 1
    return out


def top2_match(desc_db, valid_db, desc_q):
    """Streaming top-2 match on the card: for each query, the two nearest
    valid db rows. desc_db (M, D) bf16, valid_db (M,) bool, desc_q (Kq, D)
    bf16. Returns (d1 (Kq,) f32, d2 (Kq,) f32, idx (Kq,) int32), idx -1
    when no db row is valid."""
    M, D = desc_db.shape
    K = desc_q.shape[0]
    dev = desc_db.device
    if D % 16:
        raise ValueError(f"descriptor width {D} is not a multiple of 16")
    _check(desc_db, "desc_db", torch.bfloat16, (M, D), dev)
    _check(valid_db, "valid_db", torch.bool, (M,), dev)
    _check(desc_q, "desc_q", torch.bfloat16, (K, D), dev)
    lib = _load()
    nb = lib.vslam_top2_num_blocks(M)
    part_best = torch.empty(nb * K, dtype=torch.float32, device=dev)
    part_second = torch.empty(nb * K, dtype=torch.float32, device=dev)
    part_idx = torch.empty(nb * K, dtype=torch.int32, device=dev)
    d1 = torch.empty(K, dtype=torch.float32, device=dev)
    d2 = torch.empty(K, dtype=torch.float32, device=dev)
    idx = torch.empty(K, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vslam_top2_match(
        desc_db.data_ptr(), valid_db.data_ptr(), M, desc_q.data_ptr(), K, D,
        part_best.data_ptr(), part_second.data_ptr(), part_idx.data_ptr(),
        d1.data_ptr(), d2.data_ptr(), idx.data_ptr(), stream,
    )
    _raise_on(err, "top2_match kernel")
    LAUNCHES["top2_match"] += 1
    return d1, d2, idx
