"""Multi-sequence execution across devices: one sequence per device.

Port of `vslam_tpu/parallel/mesh.py`. The JAX package lays a batch of
independent sequences over a `jax.sharding.Mesh` and runs each device's
share under `shard_map`; its only collective is the `psum` behind
`batched_diagnostics`. The port keeps the names and the semantics:

  * `Mesh` (from `make_mesh`) holds the devices (`cuda:0..n-1`, or n
    CPU ranks) and the axis name. Its work runs in one worker process
    per device, started on first use with the `spawn` method and joined
    into a `torch.distributed` group (NCCL on the card, gloo on the CPU)
    rendezvousing through a `file://` store in a temporary directory. The
    tracking step is host-bound (it reads its branch predicates back),
    so threads of one interpreter would serialise on its lock; processes
    do not. The workers stay up between calls (a timed run then does not
    pay their start-up) until `Mesh.close()` or the end of the program.
  * States and frames travel to and from the workers as numpy
    (`core.state.to_numpy` / `from_numpy`). Each worker applies the
    parent's backend settings (TF32, cuDNN, determinism, CPU threads) and
    kernel build directory (`utils.cache`) before any work, so a member
    tracked in a worker gives the bits it gives in the parent. The
    parent builds the CUDA kernels before it starts the workers.
  * Each call records, per rank, the kernel launches
    (`ops.cuda_matching.LAUNCHES`) and the tracking counters
    (`core.tracking.STATS`) of the work it ran there, in `Mesh.stats`.
  * `shard_batched` gives each device its members as contiguous copies:
    the port writes the keyframe ring in place, so views must not share
    a ring (see `replicate_state`).
"""

from __future__ import annotations

import atexit
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import List, Optional

import numpy as np
import torch

from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core import tracking, tracking_batched
from vslam_tpu_torch.core.state import (
    FrameFeatures,
    StepOutputs,
    TrackState,
    copy_to,
    from_numpy,
    init_state,
    member,
    stack_trees,
    to_numpy,
)
from vslam_tpu_torch.ops import cuda_matching
from vslam_tpu_torch.utils import cache

RESULT_POLL_S = 5.0
CLOSE_WAIT_S = 30.0


def replicate_state(config: SlamConfig, batch: int, device="cuda") -> TrackState:
    """`batch` independent initial tracking states, leaves (batch, ...).

    Every member owns its storage. The JAX package broadcasts one state,
    which is safe only because JAX never writes an array in place; the
    port writes the keyframe ring in place (`core.tracking`), so views of
    one state would share a ring."""
    return stack_trees([init_state(config, device=device)] * batch)


# ------------------------------------------------------------------ workers


def _settings():
    """The parent's global settings that change what a worker computes."""
    return dict(
        float32_matmul_precision=torch.get_float32_matmul_precision(),
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32,
        cudnn_benchmark=torch.backends.cudnn.benchmark,
        cudnn_deterministic=torch.backends.cudnn.deterministic,
        deterministic=torch.are_deterministic_algorithms_enabled(),
        threads=torch.get_num_threads(),
        build_dir=cache.cache_dir(),
    )


def _apply(settings):
    torch.set_float32_matmul_precision(settings["float32_matmul_precision"])
    torch.backends.cuda.matmul.allow_tf32 = settings["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = settings["cudnn_tf32"]
    torch.backends.cudnn.benchmark = settings["cudnn_benchmark"]
    torch.backends.cudnn.deterministic = settings["cudnn_deterministic"]
    torch.use_deterministic_algorithms(settings["deterministic"])
    torch.set_num_threads(settings["threads"])
    cache.enable_persistent_cache(settings["build_dir"])


def _job_track(p, dev):
    """One member's tracking scan (`run_frames`, the keying of
    `make_scan_step`)."""
    state = from_numpy(p["state"], dev)
    frames = from_numpy(p["frames"], dev)
    st, outs = tracking.run_frames(state, frames, p["frame_ids"], p["config"], p["seed"])
    return to_numpy(st), to_numpy(outs)


def _job_coupled(p, dev):
    """One member's `run_coupled`."""
    from vslam_tpu_torch.core import coupled
    from vslam_tpu_torch.ops import gridhash

    model = p["model"].to(dev)
    depth_model = None if p["depth_params"] is None else p["depth_params"].to(dev)
    t = {k: torch.from_numpy(p[k]) for k in ("gray", "depth", "ts", "fids", "stat")}
    rgb = None if p["rgb"] is None else torch.from_numpy(p["rgb"])
    st, dn, outs = coupled.run_coupled(
        model, from_numpy(p["state"], dev),
        gridhash.DenseMapState(*from_numpy(p["dense"], dev)), t["gray"], t["depth"], rgb,
        t["ts"], t["fids"], t["stat"], p["config"], p["seed"], depth_params=depth_model,
        device=dev)
    return to_numpy(st), to_numpy(dn), to_numpy(outs)


def _job_diagnostics(p, dev):
    """This rank's sums of the four diagnostics, summed over the mesh by
    one all-reduce."""
    import torch.distributed as dist

    sums = torch.tensor([p["num_matches"].sum(), p["num_inliers"].sum(),
                         p["is_keyframe"].sum(), p["tracking_ok"].sum(),
                         p["num_matches"].size], dtype=torch.float64, device=dev)
    dist.all_reduce(sums)
    return sums.cpu().numpy()


_JOBS = {"track": _job_track, "coupled": _job_coupled, "diagnostics": _job_diagnostics}


def _worker(rank, devices, init_method, settings, jobs, results):
    """A mesh rank: joins the process group, then runs jobs until told to
    stop. Module level, so that a spawned process can import it."""
    import torch.distributed as dist

    _apply(settings)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, world_size=len(devices), rank=rank)
    while True:
        job = jobs.get()
        if job is None:
            break
        name, payload = job
        cuda_matching.reset_launch_counts()
        tracking.reset_stats()
        try:
            value = _JOBS[name](payload, dev)
        except Exception:  # reported to the parent, which raises it
            results.put((rank, traceback.format_exc(), None, None))
            continue
        stats = {"launches": dict(cuda_matching.LAUNCHES), "tracking": dict(tracking.STATS)}
        results.put((rank, None, value, stats))
    dist.destroy_process_group()


class Mesh:
    """Devices along one named axis, with a worker process per device
    (started on first use; see the module docstring)."""

    def __init__(self, devices, axis="seq"):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis = axis
        self.stats: List[dict] = []
        self._procs = None

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"

    def _start(self):
        if self._procs is not None:
            return
        if any(d.type == "cuda" for d in self.devices):
            cuda_matching.build()  # once here, not once per worker
        ctx = torch.multiprocessing.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="vslam_mesh_")
        init = "file://" + os.path.join(self._tmp, "store")
        self._jobs = [ctx.Queue() for _ in self.devices]
        self._results = ctx.Queue()
        devices = [str(d) for d in self.devices]
        settings = _settings()
        self._procs = [
            ctx.Process(target=_worker, args=(r, devices, init, settings, self._jobs[r],
                                              self._results), daemon=True)
            for r in range(self.size)
        ]
        for p in self._procs:
            p.start()
        atexit.register(self.close)

    def run(self, job: str, payloads):
        """Run `job` on every rank, rank r on `payloads[r]`; returns the
        values in rank order and records each rank's counters in
        `self.stats`. Raises if a rank fails."""
        self._start()
        for q, p in zip(self._jobs, payloads):
            q.put((job, p))
        got = {}
        while len(got) < self.size:
            try:
                rank, err, value, stats = self._results.get(timeout=RESULT_POLL_S)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                if dead:
                    self.close()
                    raise RuntimeError(f"mesh worker(s) {dead} exited during {job!r}")
                continue
            got[rank] = (err, value, stats)
        errors = [f"rank {r}:\n{e}" for r, (e, _, _) in sorted(got.items()) if e]
        if errors:
            raise RuntimeError(f"mesh job {job!r} failed\n" + "\n".join(errors))
        self.stats = [got[r][2] for r in range(self.size)]
        return [got[r][1] for r in range(self.size)]

    def close(self):
        """Stop the workers and remove the rendezvous directory."""
        if self._procs is None:
            return
        for q in self._jobs:
            q.put(None)
        deadline = time.monotonic() + CLOSE_WAIT_S
        while any(p.is_alive() for p in self._procs) and time.monotonic() < deadline:
            try:  # a worker exits once what it put is read: drain before joining
                self._results.get(timeout=0.1)
            except queue.Empty:
                pass
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(self._tmp, ignore_errors=True)
        self._procs = None
        atexit.unregister(self.close)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_mesh(n_devices: Optional[int] = None, axis="seq", device="cuda") -> Mesh:
    """A mesh of `n_devices` cards (`cuda:0..n-1`; default all), or with
    `device="cpu"` of `n_devices` CPU ranks (default 1). Raises without a
    card, or when more cards are asked for than there are."""
    if torch.device(device).type == "cpu":
        return Mesh(["cpu"] * (n_devices or 1), axis)
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' for a CPU mesh)")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh: {n} device(s) asked for, {count} present")
    return Mesh([f"cuda:{i}" for i in range(n)], axis)


# ------------------------------------------------------------------ layout


def _lead(tree) -> int:
    return next(x for x in tree if x is not None).shape[0]


def _members(tree):
    """The per-member trees of a batched tree, or of a `shard_batched`
    list (each entry holding its device's members)."""
    if isinstance(tree, list):
        return [member(t, j) for t in tree for j in range(_lead(t))]
    return [member(tree, b) for b in range(_lead(tree))]


def _batch(tree) -> int:
    if isinstance(tree, list):
        return sum(_lead(t) for t in tree)
    return _lead(tree)


def shard_batched(tree, mesh: Mesh, axis="seq"):
    """Place a batched tree (leaves (B, ...), B a multiple of the mesh
    size) over the mesh: a list with one tree per device, holding that
    device's consecutive members as contiguous copies on it."""
    B, n = _batch(tree), mesh.size
    if B % n:
        raise ValueError(f"shard_batched: batch {B} does not divide over {n} device(s)")
    k = B // n
    mem = _members(tree)
    return [stack_trees([copy_to(m, d) for m in mem[r * k:(r + 1) * k]])
            for r, d in enumerate(mesh.devices)]


def _gather(trees, device):
    """Per-member numpy trees -> one batched tree of tensors on `device`."""
    return stack_trees([from_numpy(t, device) for t in trees])


def _need_one_per_device(name, B, mesh, alternative):
    if B != mesh.size:
        raise ValueError(
            f"{name} needs batch == mesh size (got B={B}, mesh={mesh.size}); "
            f"use {alternative} for within-device batching")


# ------------------------------------------------------------------ scans


def batched_tracking_scan(states: TrackState, frames: FrameFeatures, config: SlamConfig,
                          seed: int = 42):
    """Multi-sequence batch on one device: the hand-batched step
    (`core.tracking_batched`) over (B, N, ...) frame stacks."""
    return tracking_batched.batched_tracking_scan(states, frames, config, seed=seed)


def vmapped_tracking_scan(states: TrackState, frames: FrameFeatures, config: SlamConfig,
                          seed: int = 42):
    """Reference form: each member alone through `make_scan_step`, on the
    device it lies on. Frames (B, N, ...); reads the frame ids back once.
    Returns (states, outputs with (B, N, ...) leaves)."""
    step = tracking.make_scan_step(config, seed)
    ids = frames.frame_id.tolist()
    finals, outs = [], []
    for b, (st, fr) in enumerate(zip(_members(states), _members(frames))):
        st = copy_to(st, st.kf_R.device)  # the step writes the ring in place
        seq_outs = []
        for i, fid in enumerate(ids[b]):
            st, out = step(st, tracking.frame_at(fr, i), fid)
            seq_outs.append(out)
        finals.append(st)
        outs.append(stack_trees(seq_outs))
    return stack_trees(finals), stack_trees(outs)


def sharded_tracking_scan(states: TrackState, frames: FrameFeatures, config: SlamConfig,
                          mesh: Mesh, seed: int = 42, axis: str = "seq"):
    """One sequence per device: each rank runs its member's unbatched
    tracking scan (`make_scan_step`). `states` / `frames` have leading
    batch == mesh size (batched trees or `shard_batched` lists); frames
    (B, N, ...). Returns (states, outputs with (B, N, ...) leaves) on the
    mesh's first device."""
    _need_one_per_device("sharded_tracking_scan", _batch(frames), mesh,
                         "batched_tracking_scan")
    payloads = []
    for st, fr in zip(_members(states), _members(frames)):
        fr = to_numpy(fr)
        payloads.append(dict(state=to_numpy(st), frames=fr, frame_ids=fr.frame_id.tolist(),
                             config=config, seed=seed))
    res = mesh.run("track", payloads)
    dev = mesh.devices[0]
    return _gather([r[0] for r in res], dev), _gather([r[1] for r in res], dev)


def sharded_coupled_run(model, states, dense, gray, depth_u16, rgb, timestamps, frame_ids,
                        stationary, config: SlamConfig, mesh: Mesh, axis: str = "seq",
                        seed: int = 42, depth_params=None):
    """The full coupled pipeline (`core.coupled.run_coupled`), one sequence
    per device. Arguments have `run_coupled`'s layout plus a leading batch
    axis == mesh size: gray / depth (B, S, C, H, W), rgb (B, S, C, H, W, 3)
    or None, timestamps / frame_ids / stationary (B, S, C), state and
    dense-map leaves (B, ...). `model` (and `depth_params`) are copied to
    every rank. Returns (states, dense, outputs) with leaves (B, ...) /
    (B, S*C, ...) on the mesh's first device."""
    from vslam_tpu_torch.ops import gridhash

    _need_one_per_device("sharded_coupled_run", gray.shape[0], mesh, "run_coupled_batched")
    host = lambda x: None if x is None else x.detach().cpu()  # noqa: E731
    model_h = _cpu_module(model)
    depth_h = None if depth_params is None else _cpu_module(depth_params)
    payloads = []
    for b, (st, dn) in enumerate(zip(_members(states), _members(dense))):
        payloads.append(dict(
            model=model_h, depth_params=depth_h, state=to_numpy(st), dense=to_numpy(dn),
            gray=host(gray[b]).numpy(), depth=host(depth_u16[b]).numpy(),
            rgb=None if rgb is None else host(rgb[b]).numpy(),
            ts=host(timestamps[b]).numpy(), fids=host(frame_ids[b]).numpy(),
            stat=host(stationary[b]).numpy(), config=config, seed=seed))
    res = mesh.run("coupled", payloads)
    dev = mesh.devices[0]
    dense_out = stack_trees([gridhash.DenseMapState(*from_numpy(r[1], dev)) for r in res])
    return _gather([r[0] for r in res], dev), dense_out, _gather([r[2] for r in res], dev)


def _cpu_module(m):
    import copy

    return copy.deepcopy(m).cpu()


def batched_diagnostics(outputs: StepOutputs, mesh: Mesh, axis="seq"):
    """Cross-sequence metric aggregation, the lone collective: each rank
    sums its members' outputs, one all-reduce sums the ranks. Means are
    the sum times the f32 reciprocal of the count (as XLA computes
    `jnp.mean` under `jit`). Returns 0-dim CPU tensors."""
    B, n = outputs.num_matches.shape[0], mesh.size
    if B % n:
        raise ValueError(f"batched_diagnostics: batch {B} does not divide over {n} device(s)")
    k = B // n
    host = {f: getattr(outputs, f) for f in ("num_matches", "num_inliers", "is_keyframe",
                                             "tracking_ok")}
    host = {f: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for f, v in host.items()}
    payloads = [{f: v[r * k:(r + 1) * k] for f, v in host.items()} for r in range(n)]
    sums = mesh.run("diagnostics", payloads)[0]
    inv = np.float32(1.0) / np.float32(sums[4])
    return {
        "mean_matches": torch.tensor(np.float32(sums[0]) * inv),
        "mean_inliers": torch.tensor(np.float32(sums[1]) * inv),
        "keyframes": torch.tensor(np.int32(sums[2])),
        "tracked_frac": torch.tensor(np.float32(sums[3]) * inv),
    }
