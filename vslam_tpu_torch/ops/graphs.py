"""Captured CUDA graphs of pure device functions.

Much of the tracking step is pure device work: thousands of small
kernels between two branch reads, whose launches the host pays one by
one. A function of a flat tuple of tensors and hashable static
parameters, `fn(*inputs, *statics)`, that reads nothing back and returns
a tuple of tensors, is captured here once per key (the function, its
statics, the inputs' shapes and dtypes, the device and the TF32 flags)
as a CUDA graph and replayed afterwards: the same kernels on the same
inputs, so the same bits, for a few launches a call.

The callers: the epipolar RANSACs (`ops.ransac`, a host draw among the
inputs), the 3D-3D half of the tracking step's `step.motion` block
(`core.tracking._rigid_motion`: keypoint depths, backprojection and the
Kabsch RANSAC, its draw among the inputs too) and the two halves of its
`step.pose` block (the EKF fusion, and the GN-PnP refine with the
keyframe policy). `STATS` counts captures and replays per function name.
"""

from __future__ import annotations

import torch

from vslam_tpu_torch.ops import device, linalg

# Counters a caller can read after a run: for each function's name, the
# graphs captured of it and their replays.
STATS = {}


def reset_stats():
    STATS.clear()


def _count(fn, what):
    counts = STATS.setdefault(fn.__name__, {"captures": 0, "replays": 0})
    counts[what] += 1


def _cache_misses():
    return (device._constant.cache_info().misses, device._reciprocal.cache_info().misses,
            linalg._start_vector.cache_info().misses)


def _device_of(inputs):
    """The CUDA device of the inputs (a host draw may sit among them on the
    CPU), else the first input's."""
    return next((x.device for x in inputs if x.is_cuda), inputs[0].device)


class Graph:
    """One captured CUDA graph of `fn`: static buffers for the inputs, the
    outputs the graph writes, and the cached constants it reads by
    address. One per key in `_GRAPHS`, all of a device in one memory pool
    (`_POOLS`): the replays run one after another on the caller's stream,
    and each copies its outputs out before the next, so no replay reads
    what another wrote."""

    def __init__(self, fn, statics, inputs):
        dev = _device_of(inputs)
        if dev not in _POOLS:
            _POOLS[dev] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev))
        pool, side = _POOLS[dev]
        self.replays = 0
        self.inputs = [torch.empty(x.shape, dtype=x.dtype, device=dev) for x in inputs]
        self._load(inputs)
        side.wait_stream(torch.cuda.current_stream(dev))
        with device.holding() as self.held, torch.cuda.device(dev), torch.cuda.stream(side):
            # The warm-up fills the caches of constants, whose first copy
            # from pageable memory could not be captured.
            fn(*self.inputs, *statics)
            misses = _cache_misses()
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.outputs = fn(*self.inputs, *statics)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        if _cache_misses() != misses:
            raise RuntimeError(f"{fn.__name__}: a cached constant was evicted during capture")
        self.fn = fn
        _count(fn, "captures")

    def _load(self, inputs):
        for buf, x in zip(self.inputs, inputs):
            if x.is_cuda:
                buf.copy_(x)
            else:  # a host draw, through pinned memory
                buf.copy_(x.pin_memory(), non_blocking=True)

    def replay(self, inputs):
        """The outputs for `inputs`, copied out of the graph's buffers.
        Reads nothing back from the card."""
        self._load(inputs)
        self.graph.replay()
        self.replays += 1
        _count(self.fn, "replays")
        return tuple(x.clone() for x in self.outputs)


_GRAPHS = {}
_POOLS = {}


def graph_key(fn, statics, inputs):
    """What a graph is captured for: the function, its static parameters,
    the shapes and dtypes of the inputs, the device and the TF32 flags
    (`linalg.f32_matmuls`)."""
    return (fn, statics, tuple((x.shape, x.dtype) for x in inputs), _device_of(inputs),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def graph(fn, statics, inputs):
    """The graph of `fn` for these statics and inputs, captured on first
    use (a graph not yet replayed was captured by this call)."""
    key = graph_key(fn, statics, inputs)
    if key not in _GRAPHS:
        _GRAPHS[key] = Graph(fn, statics, inputs)
    return _GRAPHS[key]


def call(fn, statics, inputs):
    """`fn(*inputs, *statics)`: on CUDA inputs a replay of its graph, on
    CPU inputs the eager code."""
    if any(x.is_cuda for x in inputs):
        return graph(fn, statics, inputs).replay(inputs)
    return fn(*inputs, *statics)
