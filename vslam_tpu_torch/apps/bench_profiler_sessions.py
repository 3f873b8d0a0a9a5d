"""How often a `torch.profiler` session loses the card's records.

Runs back-to-back `utils.profiling.framed_session`s of one short call
(`--launches` elementwise adds), in turns with the host idle `--pad-ms`
at each edge of the session and without, for `--seconds`. For each kind
it counts the sessions that hold both markers and the call's every
record (`whole`), those that lack the first marker (`lost_first`), the
last (`lost_last`) or both (`lost_both`), and those whose markers frame
another count (`wrong_count`). This is the measurement behind
`utils.profiling.EDGE_PAD_S` and the markers. Runs on the card only.

Usage: python -m vslam_tpu_torch.apps.bench_profiler_sessions
       [--seconds 60] [--launches 100] [--pad-ms 5]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from vslam_tpu_torch.utils.profiling import MARKER_KERNEL, framed_count, framed_session


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=60.0, help="time for all sessions")
    ap.add_argument("--launches", type=int, default=100, help="kernels of the framed call")
    ap.add_argument("--pad-ms", type=float, default=5.0, help="host idle at each edge")
    return ap.parse_args(argv)


def main(argv=None):
    out = run(parse_args(argv))
    print(json.dumps(out))
    return out


def run(args):
    """The sessions of parsed `args`. Returns {"launches", "pad_ms",
    "sessions": {kind: {"whole", "lost_first", "lost_last", "lost_both",
    "wrong_count"}}}, kind "idle" or "no_idle"."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_profiler_sessions runs on the card")
    x = torch.ones(64, device="cuda")

    def call():
        y = x
        for _ in range(args.launches):
            y = y + 1

    kinds = {"idle": args.pad_ms / 1e3, "no_idle": 0.0}
    counts = {k: dict.fromkeys(("whole", "lost_first", "lost_last", "lost_both", "wrong_count"), 0)
              for k in kinds}
    framed_session(call, 0.0)  # the profiler's first session sets it up
    end = time.perf_counter() + args.seconds
    while time.perf_counter() < end:
        for kind, pad_s in kinds.items():
            names = framed_session(call, pad_s)
            n, c = framed_count(names), counts[kind]
            marks = [i for i, m in enumerate(names) if MARKER_KERNEL in m]
            if n == args.launches:
                c["whole"] += 1
            elif n is not None:
                c["wrong_count"] += 1
            elif not marks:
                c["lost_both"] += 1
            else:  # one marker: the last record is the last marker, if it came
                c["lost_first" if marks[0] == len(names) - 1 else "lost_last"] += 1
    return {"launches": args.launches, "pad_ms": args.pad_ms, "sessions": counts}


if __name__ == "__main__":
    main()
