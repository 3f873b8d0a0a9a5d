"""The readings the correctness limits are set from, for one cell at its
own size, on the card:

    python3 -m slam_bench.study --workload <cell> --worlds 0,1,2 [--out FILE]
        [--faults unchanged,half,altered,swap] [--altered-m 0.1] [--faults-only]

For each world (one whole sequence of the traffic; streams take
consecutive worlds), the numbers of `check.py` for
- `sound`: the program as the cell runs it;
- `control`: the plain reference put in the program's frontend, computed
  with fp8 (e4m3) inputs and weights, against the float32 reference;
- `unchanged`: a tracking step that returns its state unchanged (the
  pose it reports is the state's);
- `half`: half of each frontend batch left out (no keypoints; every
  other frame where a call holds one);
- `altered`: one frame's pose (the middle one of the sequence) moved
  `--altered-m` (0.1 m) where the tracking step produces it;
- `swap` (several streams only): every step's outputs of member 0 copied
  into member 1's where the batched tracking step produces them.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time

from slam_bench import registry
from slam_bench.run import Record, check_outputs

FAULTS = ("unchanged", "half", "altered", "swap")
ALTERED_M = 0.1


def faults_of(streams: int) -> tuple:
    """The faults a cell of `streams` streams can have."""
    return FAULTS if streams > 1 else tuple(f for f in FAULTS if f != "swap")


@contextlib.contextmanager
def planted(fault: str, batched: bool, altered_frame: int, altered_m: float = ALTERED_M):
    """The program with `fault` planted, for the block."""
    from vslam_tpu_torch.core import frontend, tracking, tracking_batched

    if fault == "half":
        mod, attr = frontend, "frontend_features"
    else:
        mod, attr = (tracking_batched, "tracking_step_batched") if batched else (
            tracking, "tracking_step")
    orig = getattr(mod, attr)
    box = {"n": 0, "out": None}

    def half(*args, **kwargs):
        out = orig(*args, **kwargs)
        valid = out.valid.clone()
        n = valid.shape[0]
        if n > 1:
            valid[n // 2:] = False
        elif box["n"] % 2:  # one frame a call: every other call's
            valid[:] = False
        box["n"] += 1
        return out._replace(valid=valid)

    def unchanged(state, frame, config, key):
        if box["out"] is None:
            _, box["out"] = orig(state, frame, config, key)
        return state, box["out"]._replace(R=state.R.clone(), t=state.t.clone())

    def altered(state, frame, config, key):
        st, out = orig(state, frame, config, key)
        if box["n"] == altered_frame:
            t = out.t.clone()
            t[..., 0] += altered_m
            out = out._replace(t=t)
        box["n"] += 1
        return st, out

    def swap(states, frames, config, keys):
        st, out = orig(states, frames, config, keys)

        def first_into_second(x):
            x = x.clone()
            x[1] = x[0]
            return x

        return st, type(out)(*(first_into_second(x) for x in out))

    if fault == "swap" and not batched:
        raise ValueError("the swap fault needs several streams")
    setattr(mod, attr, {"half": half, "unchanged": unchanged, "altered": altered,
                        "swap": swap}[fault])
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def one_sequence(spec, world: int, device, fault=None, workers=None, altered_m=ALTERED_M):
    """The numbers of one whole sequence from world `world` on, with
    `fault` planted (None: the program as it is)."""
    from slam_bench.system import RENDER_WORKERS, System
    from slam_bench.trace import Hooks

    spec = copy.deepcopy(spec)
    tr = spec["traffic"]
    tr["world_seeds"] = list(range(world, world + tr["streams"]))
    system = System(spec["config"], tr, device=device, workers=workers or RENDER_WORKERS)
    per_seq = system.N // system.per_call
    # The fault goes beneath the benchmark's hooks, which see what the
    # program returns.
    with (planted(fault, system.B > 1, system.N // 2, altered_m) if fault
          else contextlib.nullcontext()):
        hooks = Hooks(False, tr["profile_frames"], tr["chunk"])
        try:
            hooks.capture = True
            calls = [system.next_call(spec["config"]["ransac_seed"]) for _ in range(per_seq)]
        finally:
            hooks.remove()
    record = Record(calls, system.B, per_seq, 0.0)
    numbers = check_outputs(system, record, {0: (hooks.captured, system.last_dense)},
                            spec["limits"], system.dev)
    return numbers, system


def control_numbers(spec, system, device):
    """The control's frontend numbers on the system's frames."""
    from slam_bench import check
    from slam_bench.reference.frontend import fp8_quant

    gray = system.gray.flatten(0, 1) if system.B > 1 else system.gray[:, 0]
    feats = check.reference_features(gray, spec["config"], system.dev, fp8_quant)
    return check.frontend_numbers(feats, gray, spec["config"], system.dev)


def study(spec, worlds, device, faults, workers=None, log=sys.stderr, altered_m=ALTERED_M,
          sound=True) -> dict:
    out = {}
    for w in worlds:
        t0 = time.perf_counter()
        row = {}
        if sound:
            row["sound"], system = one_sequence(spec, w, device, workers=workers)
            row["control"] = control_numbers(spec, system, device)
            del system
        for fault in faults:
            row[fault], _ = one_sequence(spec, w, device, fault, workers=workers,
                                         altered_m=altered_m)
        row["seconds"] = time.perf_counter() - t0
        out[str(w)] = row
        print(f"world {w}: {json.dumps(row)}", file=log, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--worlds", default="0,1,2")
    ap.add_argument("--faults", default=None, help="default: every fault the cell can have")
    ap.add_argument("--altered-m", type=float, default=ALTERED_M)
    ap.add_argument("--faults-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    spec = registry.cell(args.workload)
    faults = (faults_of(spec["traffic"]["streams"]) if args.faults is None
              else [f for f in args.faults.split(",") if f])
    res = dict(cell=args.workload, limits=spec["limits"], altered_m=args.altered_m,
               readings=study(spec, [int(w) for w in args.worlds.split(",")], "cuda", faults,
                              altered_m=args.altered_m, sound=not args.faults_only))
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
