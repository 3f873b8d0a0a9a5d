"""What the benchmark reads from the program while the window runs,
from outside it: the frontend's outputs of the calls whose answers are
checked, and (in a traced run) spans around the calls into each layer,
a `torch.profiler` trace of one chunk, and the host's syncs.

Spans are defined by the files in `spans/` (`MODULE`, `ATTR`,
`frames(args)` and, where the work of the call is counted, `keep(args)`);
a traced run wraps only the spans its cell's per-layer metrics name
(`SPANS` in `metrics/<name>.py`), so a span file added later changes no
other cell. A span wraps the module attribute the entry calls through,
synchronises the card at both edges and records the host's wall clock.
A span nested in another (`SYNC = False`: the radius match inside the
tracking step) adds no sync: it acts only in the traced chunk, where
marker kernels around the call delimit its records. A name that has
gone from the program leaves its span empty.

The trace is taken after the window (a finished `torch.profiler` session
leaves later launches slower): a call of twice `profile_frames` frames
of each stream from a fresh state runs, and the trace covers its second
half, from the frontend call that starts it to the end of the tracking
call that finishes it. It is framed
as the port's `utils/profiling.framed_session` frames a session (copied
at commit a3a4213): the host idles 50 ms, two primer kernels and a marker
kernel (`torch.cuda._sleep`) go first, a marker last, and the host idles
again; the chunk's records are those between the markers, read from the
raw kineto events.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import importlib.util
import inspect
import os
import re
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MARKER_KERNEL = "spin_kernel"
EDGE_PAD_S = 0.05


def span_defs(names=None, folder: str = None) -> dict:
    """The span files `names` (every file in the folder when None)."""
    folder = folder or os.path.join(HERE, "spans")
    out = {}
    for f in sorted(os.listdir(folder)):
        if f.endswith(".py") and not f.startswith("_") and (names is None or f[:-3] in names):
            spec = importlib.util.spec_from_file_location(f"slam_bench_span_{f[:-3]}",
                                                          os.path.join(folder, f))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out[f[:-3]] = mod
    return out


@dataclasses.dataclass
class Span:
    name: str
    t0_ns: int
    t1_ns: int
    frames: int
    in_window: bool
    profiled: bool
    kept: dict = None
    synced: bool = True  # False: t0/t1 are launch times, not the card's

    def kept_on_host(self) -> dict:
        return {k: v if isinstance(v, (int, float)) else _host_array(v)
                for k, v in self.kept.items()}


def _host_array(x):
    import torch

    if isinstance(x, (list, tuple)):
        x = torch.stack(list(x))
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Hooks:
    """Wraps the program's module attributes for one run; `remove()`
    puts the originals back."""

    def __init__(self, traced: bool, profile_frames: int, chunk: int, spans=()):
        self.traced = traced
        self.profile_calls = max(1, profile_frames // chunk)
        self.capture = False
        self.captured = []  # frontend outputs of the captured calls
        self.spans = []
        self.in_window = False
        self.armed = False  # counting calls towards the trace
        self.frontend_calls = 0
        self.track_calls = 0
        self.profile = None  # dict once the trace is taken
        self._prof = None
        self._stop_at = None
        self._saved = []
        self.missing = []
        defs = span_defs(set(spans)) if traced else {}
        # The frontend is always wrapped: its outputs are checked.
        self._wrap("frontend", "vslam_tpu_torch.core.frontend", "frontend_features",
                   defs.get("frontend"))
        for name, d in defs.items():
            if name != "frontend":
                self._wrap(name, d.MODULE, d.ATTR, d)

    def _wrap(self, name, module, attr, d):
        mod = importlib.import_module(module)
        fn = getattr(mod, attr, None)
        if fn is None:
            self.missing.append(f"{module}.{attr}")
            return
        self._saved.append((mod, attr, fn))
        sig = inspect.signature(fn)
        hooks = self

        def wrapped(*args, **kwargs):
            if not hooks.traced or d is None:
                out = fn(*args, **kwargs)
                if hooks.capture:
                    hooks.captured.append(out)
                return out
            return hooks._span(name, d, sig, fn, args, kwargs)

        setattr(mod, attr, wrapped)

    def arm(self):
        """Count calls from here on: the trace starts at the frontend call
        after `profile_frames` frames and ends with the tracking call that
        completes the next `profile_frames`."""
        self.armed, self.frontend_calls, self.track_calls = True, 0, 0

    def remove(self):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []

    # -- traced runs ---------------------------------------------------

    def _span(self, name, d, sig, fn, args, kwargs):
        import torch

        a = sig.bind(*args, **kwargs).arguments
        if name == "frontend" and self.armed:
            if self.frontend_calls == self.profile_calls and self._prof is None:
                self._start_profile()
                self._stop_at = self.track_calls + self.profile_calls
            self.frontend_calls += 1
        profiled = self._prof is not None
        synced = getattr(d, "SYNC", True)
        if not synced and not profiled:
            return fn(*args, **kwargs)
        # A span whose work is counted gets marker kernels of its own in
        # the trace: its records are those between them, in stream order.
        marked = profiled and hasattr(d, "keep")
        if synced:
            torch.cuda.synchronize()
        t0 = time.time_ns()
        if marked:
            torch.cuda._sleep(1)
        out = fn(*args, **kwargs)
        if marked:
            torch.cuda._sleep(1)
        if synced:
            torch.cuda.synchronize()
        t1 = time.time_ns()
        # References only: the host copies wait until the trace is over.
        kept = d.keep(a) if marked else None
        self.spans.append(Span(name, t0, t1, d.frames(a), self.in_window, profiled, kept,
                               synced))
        if name == "frontend" and self.capture:
            self.captured.append(out)
        if name.startswith("track") and self.armed:
            self.track_calls += 1
            if self._prof is not None and self.track_calls >= self._stop_at:
                self._stop_profile()
        return out

    def _start_profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        primer = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(EDGE_PAD_S)
        primer.add_(1)
        primer.add_(1)
        self._mark0_ns = time.time_ns()
        torch.cuda._sleep(1)

    def _stop_profile(self):
        import torch

        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(EDGE_PAD_S)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.profile = read_events(prof, self._mark0_ns)


def _start_ns(e):
    return e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000


def _dur_ns(e):
    return e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000


def read_events(prof, mark0_host_ns: int) -> dict:
    """The device records between the trace's first and last markers:
    names, starts and ends in host-clock ns, the traced span (first
    marker's end to the last's start), and `marked`, the [first, last)
    record indices between each pair of a marked span's own markers.
    None when a marker is missing."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    evs = sorted(((_start_ns(e), _dur_ns(e), e.name())
                  for e in prof.profiler.kineto_results.events() if e.device_type() == cuda),
                 key=lambda r: r[0])
    marks = [i for i, r in enumerate(evs) if MARKER_KERNEL in r[2]]
    if len(marks) < 2 or len(marks) % 2:
        return None
    m0, m1 = evs[marks[0]], evs[marks[-1]]
    # The trace's clock onto the host's wall clock: the first marker
    # starts a launch latency (microseconds) after the host, idle and
    # synchronised, launched it.
    shift = m0[0] - mark0_host_ns
    body, marked, open_at = [], [], None
    for r in evs[marks[0] + 1: marks[-1]]:
        if MARKER_KERNEL in r[2]:
            if open_at is None:
                open_at = len(body)
            else:
                marked.append((open_at, len(body)))
                open_at = None
        else:
            body.append(r)
    return dict(
        names=[r[2] for r in body],
        start=np.array([r[0] - shift for r in body], np.int64),
        end=np.array([r[0] + r[1] - shift for r in body], np.int64),
        span0=m0[0] + m0[1] - shift,
        span1=m1[0] - shift,
        marked=marked,
        shift_ns=shift,
    )


def busy_intervals(start, end):
    """The union of [start, end) intervals, as (starts, ends) sorted."""
    if len(start) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    ends = np.append(run_end[idx[1:] - 1], run_end[-1])
    return s[idx], ends


def idle_by_span(profile: dict, spans, top: int = 10):
    """Idle device time inside the traced span, by the innermost
    synchronised span the host was in at the middle of each gap
    ("harness" outside all)."""
    bs, be = busy_intervals(profile["start"], profile["end"])
    gaps_s = np.concatenate([[profile["span0"]], be])
    gaps_e = np.concatenate([bs, [profile["span1"]]])
    keep = gaps_e > gaps_s
    gaps_s, gaps_e = gaps_s[keep], gaps_e[keep]
    mids = (gaps_s + gaps_e) // 2
    label = np.full(len(mids), "harness", dtype=object)
    width = np.full(len(mids), np.iinfo(np.int64).max)
    for sp in spans:
        if not (sp.profiled and sp.synced):
            continue
        inside = (mids >= sp.t0_ns) & (mids <= sp.t1_ns) & (sp.t1_ns - sp.t0_ns < width)
        label[inside] = sp.name
        width[inside] = sp.t1_ns - sp.t0_ns
    sums = collections.defaultdict(int)
    for lab, g in zip(label, gaps_e - gaps_s):
        sums[lab] += int(g)
    return sorted(([k, v / 1e9] for k, v in sums.items()), key=lambda r: -r[1])[:top]


_INNER = re.compile(r"(\w*(?:Functor|_kernel|Kernel|gemm|conv)\w*)")


def short_name(name: str) -> str:
    """A kernel's name without its template arguments, with the first
    functor or kernel named inside them (the innermost): `at::native::elementwise_kernel
    <addcmul_cuda_kernel>`."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i >= 0), default=len(name))
    base = name[:cut]
    inner = [m for m in _INNER.findall(name[cut:])
             if m != base.split("::")[-1] and "gpu_kernel_impl" not in m]
    return f"{base}<{inner[-1]}>" if inner else base.strip()


def device_ops(profile: dict, top: int = 10):
    """Device time by kernel (short names), the largest first."""
    sums = collections.defaultdict(int)
    for n, s, e in zip(profile["names"], profile["start"], profile["end"]):
        sums[short_name(n)] += int(e - s)
    return sorted(([k, v / 1e9] for k, v in sums.items()), key=lambda r: -r[1])[:top]
