"""Wrappers of the hand-written CUDA matching kernels (`csrc/matching.cu`).

The kernels replace the three Pallas TPU kernels of the JAX package:

  radius_match          <- vslam_tpu/ops/pallas_matching.py:_radius_kernel
  radius_match_batched  <- vslam_tpu/ops/pallas_matching.py:_radius_kernel_batched
  top2_match            <- vslam_tpu/ops/pallas_matching.py:_match_kernel

`radius_match` is the B = 1 case of the batched radius kernel's device
code; each wrapper keeps its own launch count. The radius kernel's work
follows the radius gate: every map row is tested against every keypoint's
pixels, and only the pairs inside the radius read descriptors.
`radius_match_batched` takes each input either as one (B, ...) tensor or
as a sequence of B per-member tensors: the kernel receives a base pointer
per member, so the multi-sequence step hands over each member's own map
without stacking it. The top-2 kernel keeps 80-query chunks resident in
shared memory, streams the live 64-row map tiles through a double buffer
(a tile with no valid row is never loaded) and folds its per-split
partials in the same launch.

Every call is one cooperative launch, with no memset and no second
kernel; its grid, the SM count times the kernel's occupancy, is queried
once per device (and descriptor width, for top-2) and cached, so a call
makes no host query and no host sync.

The source is compiled with `nvcc` for `sm_90a` into a shared library
with a plain C interface under `vslam_tpu_torch/_build/` at first use and
loaded with ctypes. Each wrapper checks device, dtype, shape, contiguity
and alignment, allocates its outputs and scratch as views of one
`torch.empty` buffer, launches on the current stream, raises if the C
function returns a CUDA error, and adds one to its launch count.
The wrappers take CUDA tensors only: the plain versions live in
`ops.matching`.
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


def set_build_dir(path: str):
    """Build the library into, and load it from, `path`
    (`utils.cache.enable_persistent_cache`)."""
    global BUILD_DIR, LIBRARY
    BUILD_DIR = path
    LIBRARY = os.path.join(path, "libvslam_matching.so")


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
                P, PP, I, F = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, \
                    ctypes.c_float
                lib.vslam_radius_max_grid.argtypes = [I]
                lib.vslam_radius_max_grid.restype = I
                lib.vslam_radius_match.argtypes = [
                    PP, PP, PP, I, PP, PP, PP, I, I, I, F, F, P, P, P, P, P, I, P]
                lib.vslam_radius_match.restype = I
                lib.vslam_top2_max_grid.argtypes = [I, I]
                lib.vslam_top2_max_grid.restype = I
                lib.vslam_top2_match.argtypes = [P, P, I, P, I, I, P, P, P, P, P, I, P]
                lib.vslam_top2_match.restype = I
                _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device, align: int = 16) -> int:
    """Raises unless `t` is a contiguous `dtype` tensor of `shape` on the
    CUDA `device`, `align`-byte aligned; returns its data pointer."""
    if device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: expected a tensor on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    ptr = t.data_ptr()
    if ptr % align:
        raise ValueError(f"{name}: data must be {align}-byte aligned")
    return ptr


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError {err}")


MAX_MEMBERS = 64  # members per radius launch (csrc/matching.cu)
_GRIDS = {}  # (C query, device index, its arguments) -> co-resident blocks


def _max_grid(query, dev: torch.device, *args) -> int:
    """The co-resident grid of a cooperative kernel on `dev`, from its C
    occupancy query (`vslam_*_max_grid(device, *args)`), asked once."""
    key = (query.__name__, dev.index) + args
    grid = _GRIDS.get(key)
    if grid is None:
        grid = query(dev.index, *args)
        if grid <= 0:
            raise RuntimeError(f"{query.__name__} failed (cudaError {-grid})")
        _GRIDS[key] = grid
    return grid


def _one_buffer(dev: torch.device, parts):
    """Views of one uninitialised byte buffer on `dev`, one per (dtype,
    shape) in `parts`, each starting 16-byte aligned."""
    offs, n = [], 0
    for dtype, shape in parts:
        offs.append(n)
        n += -(-dtype.itemsize * torch.Size(shape).numel() // 16) * 16
    buf = torch.empty(max(n, 16), dtype=torch.uint8, device=dev)
    return [buf[o:o + dtype.itemsize * torch.Size(shape).numel()].view(dtype).view(shape)
            for o, (dtype, shape) in zip(offs, parts)]


def _radius_launch(members, radius_px, desc_thresh, batched=True):
    """Checks B members' inputs, each (desc_q (K, D), uv_q (K, 2), valid_q
    (K,), desc_db (M, D), uv_db (M, 2), valid_db (M,)), and launches the
    radius kernel over them with one base pointer per member and input.
    Returns (mp_idx (B, K), kp_ok (B, K), dist (B, K), min_pix_d2 (B, M)),
    views of one buffer; without the leading B when not `batched`."""
    B = len(members)
    if not 1 <= B <= MAX_MEMBERS:
        raise ValueError(f"radius match takes 1..{MAX_MEMBERS} members, got {B}")
    q0, db0 = members[0][0], members[0][3]
    for name, t in (("desc_q", q0), ("desc_db", db0)):
        if t.dim() != 2:
            raise ValueError(f"{name}: expected (n, D) per member, got {tuple(t.shape)}")
    K, D = q0.shape
    M = db0.shape[0]
    dev = db0.device
    if D % 16:
        raise ValueError(f"descriptor width {D} is not a multiple of 16")
    # Descriptors are read as 16-byte vectors and as 32-byte-aligned tensor-
    # core tiles, pixels as float2.
    specs = (("desc_q", torch.bfloat16, (K, D), 32), ("uv_q", torch.float32, (K, 2), 8),
             ("valid_q", torch.bool, (K,), 1), ("desc_db", torch.bfloat16, (M, D), 32),
             ("uv_db", torch.float32, (M, 2), 8), ("valid_db", torch.bool, (M,), 1))
    ptrs = [(ctypes.c_void_p * B)() for _ in specs]
    for b, args in enumerate(members):
        if len(args) != len(specs):
            raise ValueError(f"member {b}: expected {len(specs)} inputs, got {len(args)}")
        for i, (t, (name, dtype, shape, align)) in enumerate(zip(args, specs)):
            ptrs[i][b] = _check(t, name, dtype, shape, dev, align)
    lib = _load()
    grid = _max_grid(lib.vslam_radius_max_grid, dev)
    # Claims (B, K) u64 | min_pix_d2 (B, M) f32 | dist (B, K) f32 | mp_idx
    # (B, K) i32 | kp_ok (B, K) bool.
    shape = (lambda n: (B, n)) if batched else (lambda n: (n,))
    claim, min_pix_d2, dist, mp_idx, kp_ok = _one_buffer(dev, (
        (torch.int64, (B, K)), (torch.float32, shape(M)), (torch.float32, shape(K)),
        (torch.int32, shape(K)), (torch.bool, shape(K))))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vslam_radius_match(
        ptrs[0], ptrs[1], ptrs[2], K, ptrs[3], ptrs[4], ptrs[5], M, D, B,
        float(radius_px) * float(radius_px), float(desc_thresh),
        claim.data_ptr(), mp_idx.data_ptr(), kp_ok.data_ptr(), dist.data_ptr(),
        min_pix_d2.data_ptr(), grid, stream,
    )
    _raise_on(err, "radius_match kernel")
    return mp_idx, kp_ok, dist, min_pix_d2


def radius_match(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db, radius_px, desc_thresh):
    """Fused local-map radius matcher on the card. desc_q (K, D) bf16,
    uv_q (K, 2) f32, valid_q (K,) bool; desc_db (M, D) bf16, uv_db (M, 2)
    f32, valid_db (M,) bool; D a multiple of 16. Returns (mp_idx (K,)
    int32, kp_ok (K,) bool, dist (K,) f32, min_pix_d2 (M,) f32)."""
    out = _radius_launch([(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db)], radius_px,
                         desc_thresh, batched=False)
    LAUNCHES["radius_match"] += 1
    return out


def radius_match_batched(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db, radius_px,
                         desc_thresh):
    """`radius_match` for B members in one launch. Each input is either one
    (B, ...) tensor — desc_q (B, K, D), uv_q (B, K, 2), valid_q (B, K);
    desc_db (B, M, D), uv_db (B, M, 2), valid_db (B, M) — or a sequence of
    B per-member tensors of the single call's shapes (no copy is made).
    Returns (mp_idx (B, K), kp_ok (B, K), dist (B, K), min_pix_d2 (B, M))."""
    args = (desc_q, uv_q, valid_q, desc_db, uv_db, valid_db)
    for name, t in (("desc_q", desc_q), ("desc_db", desc_db)):
        if isinstance(t, torch.Tensor) and t.dim() != 3:
            raise ValueError(f"{name}: expected (B, n, D), got {tuple(t.shape)}")
    if len({len(a) for a in args}) != 1:
        raise ValueError("every input must hold the same number of members")
    out = _radius_launch(list(zip(*args)), radius_px, desc_thresh)
    LAUNCHES["radius_match_batched"] += 1
    return out


def top2_match(desc_db, valid_db, desc_q):
    """Streaming top-2 match on the card: for each query, the two nearest
    valid db rows. desc_db (M, D) bf16, valid_db (M,) bool, desc_q (Kq, D)
    bf16; D a multiple of 16, at most 496 on an H100 (the kernel's shared
    memory grows with D; a wider D raises). Returns (d1 (Kq,) f32, d2
    (Kq,) f32, idx (Kq,) int32), idx -1 and d1 = d2 = 1e9 when no db row
    is valid."""
    M, D = desc_db.shape
    K = desc_q.shape[0]
    dev = desc_db.device
    if D % 16:
        raise ValueError(f"descriptor width {D} is not a multiple of 16")
    _check(desc_db, "desc_db", torch.bfloat16, (M, D), dev)
    _check(valid_db, "valid_db", torch.bool, (M,), dev)
    _check(desc_q, "desc_q", torch.bfloat16, (K, D), dev)
    lib = _load()
    grid = _max_grid(lib.vslam_top2_max_grid, dev, D)
    # Partials (K, splits <= grid): packed (d, row) u64 | second f32; then
    # d1 | d2 f32 | idx i32.
    part_key, part_s, d1, d2, idx = _one_buffer(dev, (
        (torch.int64, (K * grid,)), (torch.float32, (K * grid,)), (torch.float32, (K,)),
        (torch.float32, (K,)), (torch.int32, (K,))))
    if K == 0:
        return d1, d2, idx
    err = lib.vslam_top2_match(
        desc_db.data_ptr(), valid_db.data_ptr(), M, desc_q.data_ptr(), K, D,
        part_key.data_ptr(), part_s.data_ptr(), d1.data_ptr(), d2.data_ptr(), idx.data_ptr(),
        grid, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "top2_match kernel")
    LAUNCHES["top2_match"] += 1
    return d1, d2, idx
