"""The system under test for one cell: `vslam_tpu_torch`'s entry
(`core.coupled.run_coupled`, or `run_coupled_batched` for several
streams), the networks its configuration names (`networks/<name>.py`,
found by `registry.networks`), its initial state, and the cell's frames
on the device.

A traffic mix (`traffic/<name>.json`) is data that this one module reads:
`streams` (1: `run_coupled`; more: `run_coupled_batched` at B =
streams), `frames_per_call` (frames of each stream handed to one call:
the sequence length for whole sequences, 1 for a live camera), `chunk`
(frames per chunk within a call), `carry_state` (hand each call the
state and dense map the previous call returned, fresh again when a
sequence ends), `world_seeds` and `orbit_radius_m` (one rendered world,
and the radius of its orbit, per stream: streams on orbits of their own
have trajectories, depth and ground truth of their own), `num_landmarks`,
`frame_dt_s`, `warmup_frames` and `profile_frames`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from slam_bench import registry
from slam_bench.frozen import generator

# Rendering processes (spawned; numpy only). The card's host has 8 cores.
RENDER_WORKERS = 8


def slam_config(config: dict):
    """`SlamConfig` with the configuration file's `slam` groups applied
    over the defaults."""
    from vslam_tpu_torch.config import SlamConfig

    cfg = SlamConfig()
    groups = {}
    for key, value in config["slam"].items():
        if isinstance(value, dict):
            groups[key] = dataclasses.replace(getattr(cfg, key), **value)
        else:
            groups[key] = value
    return cfg.replace(**groups)


@dataclasses.dataclass
class Call:
    """One call of the entry, as the window ran it."""

    index: int
    start: float
    end: float
    sequence: int  # which sequence of the stream(s) it belongs to
    first_frame: int  # its first frame's index in the sequence
    R: np.ndarray  # (frames, [B,] 3, 3) poses on the host
    t: np.ndarray  # (frames, [B,] 3)
    tracking_ok: np.ndarray  # (frames, [B])


class System:
    """Sets up the program for a cell and runs its calls."""

    def __init__(self, config: dict, traffic: dict, device="cuda", workers=RENDER_WORKERS):
        import torch

        from vslam_tpu_torch.core.state import init_state, stack_trees
        from vslam_tpu_torch.ops import gridhash

        networks = registry.networks(config)
        self.config, self.traffic = config, traffic
        self.cfg = cfg = slam_config(config)
        self.dev = dev = torch.device(device)
        self.B = traffic["streams"]
        self.N = config["sequence_frames"]
        self.per_call = traffic["frames_per_call"]
        self.chunk = traffic["chunk"]
        if self.N % self.per_call or self.per_call % self.chunk:
            raise ValueError("frames_per_call must divide the sequence and chunk it")
        c = cfg.camera
        self.cam = (c.fx, c.fy, c.cx, c.cy, c.width, c.height)
        if not len(traffic["world_seeds"]) == len(traffic["orbit_radius_m"]) == self.B:
            raise ValueError("one world seed and one orbit radius per stream")
        t0 = time.perf_counter()
        self.world = generator.make_worlds(
            traffic["world_seeds"], self.N, self.cam, num_landmarks=traffic["num_landmarks"],
            radii=traffic["orbit_radius_m"], dt=traffic["frame_dt_s"],
            depth_scale=c.depth_scale, workers=workers)
        if not config.get("sensor_depth", True):
            self.world["depth_u16"] = np.zeros_like(self.world["depth_u16"])
        self.render_s = time.perf_counter() - t0

        self.model = networks["features"].load(config, dev)
        self.depth_model = networks["depth"].load(config, dev) if "depth" in networks else None
        # Frames on the device, (N, B, H, W); sensor depth as int32 (the
        # app's and the smoke's layout).
        gray = np.ascontiguousarray(self.world["gray"].transpose(1, 0, 2, 3))
        self.gray = torch.from_numpy(gray).to(dev)
        dep = np.ascontiguousarray(self.world["depth_u16"].transpose(1, 0, 2, 3))
        self.depth = torch.from_numpy(dep.astype(np.int32)).to(dev)
        self.ts = torch.from_numpy(self.world["timestamps"].astype(np.float32)).to(dev)
        self.fid = torch.arange(self.N, dtype=torch.int32, device=dev)
        self.stat = torch.zeros(self.N, dtype=torch.bool, device=dev)
        dn = cfg.dense
        if self.B == 1:
            self.state0 = init_state(cfg, device=dev)
            self.dense0 = gridhash.init_dense_map(dn.hash_capacity, dn.cloud_capacity, device=dev)
        else:
            from vslam_tpu_torch.parallel.mesh import replicate_state

            self.state0 = replicate_state(cfg, self.B, device=dev)
            self.dense0 = stack_trees([gridhash.init_dense_map(
                dn.hash_capacity, dn.cloud_capacity, device=dev)] * self.B)
        self.state, self.dense = self.state0, self.dense0
        self.calls_done = 0
        self.last_dense = None

    def _inputs(self, f0: int, n: int):
        """The entry's inputs for frames [f0, f0 + n) of every stream,
        in chunks: (S, C, H, W) for one stream, (S, C, B, H, W) for more."""
        S, C = n // self.chunk, self.chunk
        sl = slice(f0, f0 + n)
        if self.B == 1:
            lead = (S, C)
            gray, dep = self.gray[sl, 0], self.depth[sl, 0]
            ts, fid, stat = self.ts[sl], self.fid[sl], self.stat[sl]
        else:
            lead = (S, C, self.B)
            gray, dep = self.gray[sl], self.depth[sl]
            ts, fid, stat = (x[sl, None].expand(-1, self.B) for x in (self.ts, self.fid, self.stat))
        skip = 1 if self.B == 1 else 2
        return tuple(x.reshape(lead + tuple(x.shape[skip:])) for x in (gray, dep, ts, fid, stat))

    def call(self, f0: int, n: int, seed: int):
        """Frames [f0, f0 + n) through the entry from `self.state` and
        `self.dense`; returns (state, dense, StepOutputs)."""
        from vslam_tpu_torch.core import coupled

        gray, dep, ts, fid, stat = self._inputs(f0, n)
        if self.B == 1:
            return coupled.run_coupled(self.model, self.state, self.dense, gray, dep, None, ts,
                                       fid, stat, self.cfg, seed=seed,
                                       depth_params=self.depth_model, device=self.dev)
        return coupled.run_coupled_batched(self.model, self.state, self.dense, gray, dep, ts,
                                           fid, stat, self.cfg, seed=seed, device=self.dev)

    def warm_up(self, seed: int):
        """The cell's own shapes before the window: the first
        `warmup_frames` frames of the first sequence, in chunks of
        `chunk` (in live calls, with the state handed on)."""
        n = self.traffic["warmup_frames"]
        if n % self.chunk:
            raise ValueError("warmup_frames must be whole chunks")
        if self.traffic["carry_state"]:
            for f0 in range(0, n, self.per_call):
                self.state, self.dense, _ = self.call(f0, self.per_call, seed)
        else:
            self.call(0, n, seed)
        self.state, self.dense = self.state0, self.dense0

    def traced_call(self, hooks, seed: int):
        """Twice `profile_frames` frames of each stream from a fresh state,
        in the traffic's calls, with `hooks` armed: the trace covers the
        second half."""
        n = 2 * self.traffic["profile_frames"]
        self.state, self.dense = self.state0, self.dense0
        hooks.arm()
        if self.traffic["carry_state"]:
            for f0 in range(0, n, self.per_call):
                self.state, self.dense, _ = self.call(f0, self.per_call, seed)
        else:
            self.call(0, n, seed)
        hooks.armed = False
        self.state, self.dense = self.state0, self.dense0

    def next_call(self, seed: int) -> Call:
        """The traffic's next call: the next frames of the current
        sequence (or the whole sequence), with the pose read back to the
        host. Timed from the hand-in to the poses on the host."""
        calls_per_seq = self.N // self.per_call
        k = self.calls_done
        seq, pos = divmod(k, calls_per_seq)
        f0 = pos * self.per_call
        if pos == 0 or not self.traffic["carry_state"]:
            self.state, self.dense = self.state0, self.dense0
        start = time.perf_counter()
        st, dense, out = self.call(f0, self.per_call, seed)
        R, t = out.R.cpu().numpy(), out.t.cpu().numpy()
        end = time.perf_counter()
        if self.traffic["carry_state"]:
            self.state, self.dense = st, dense
        self.last_dense = dense
        self.calls_done += 1
        return Call(k, start, end, seq, f0, R, t, out.tracking_ok.cpu().numpy())
