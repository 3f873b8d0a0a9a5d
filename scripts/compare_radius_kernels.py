#!/usr/bin/env python3
"""Times the PyTorch port's matching wrappers (radius, batched radius and
top-2) of one or more checkouts of this repository on one GPU, by
`chip_smoke.py`'s method (`time_ms`: device time of one call, the card
held busy while the host enqueues it) on `chip_smoke.py`'s inputs at the
main path's shapes (K=400 keypoints, M=16384 map rows, D=256 bf16; B=4
members for the batched call).

    python3 scripts/compare_radius_kernels.py ROOT [ROOT ...]

Each ROOT is a checkout (for another commit: a `git archive` unpacked
under the ignored `vslam_tpu_torch/_build/`). Each is timed in a process
of its own, which builds that checkout's kernels, in the order given, so
`A B B A` brackets drift. Prints one JSON line per ROOT, then the card's
name and power limit. Fields, in ms: `radius_match` and
`radius_match_batched` (structured input), `*_dense` (every pair inside
the pixel radius), and what a single call costs before its rows:
`radius_empty_map` (M = 0), `radius_one_item` (64 rows), beside
`one_element_add` (one `add_` of a one-element tensor) timed the same
way. Top-2: `top2_match` (structured input, ~85% of the rows valid),
`top2_match_all_valid`, `top2_low_slots` (the recovery map's layout:
the all-valid input with only its lowest 5,102 rows valid, 80 of 256
64-row tiles live), `top2_empty_map` (M = 0), and `top2_trace`, the
device activities (kernels and memsets) of one structured call in a
torch.profiler trace, taken last (a finished profiler session slows
later launches): `[name, device µs]` each. A field the checkout cannot
compute is null.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Valid rows of the recovery phase's map in `chip_smoke.py` (the main
# path's final map: 128 frames of the seed-0 world), all in its lowest slots.
RECOVERY_VALID_ROWS = 5102


def _smoke():
    """This checkout's chip_smoke.py (its inputs and its timing)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_method", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_root(root: str) -> dict:
    """Times the radius wrappers of the checkout at `root` (whose
    `vslam_tpu_torch` must come first on `sys.path`)."""
    import numpy as np
    import torch

    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.ops import cuda_matching

    smoke = _smoke()
    cuda_matching.build(force=True)
    cfg = SlamConfig()
    K, D = cfg.frontend.max_keypoints, cfg.frontend.descriptor_dim
    M = cfg.map.map_capacity
    kw = dict(radius_px=cfg.map.track_search_radius_px, desc_thresh=cfg.map.track_desc_threshold)
    rng = np.random.default_rng(0)
    single = {c: smoke._radius_inputs(rng, K, M, D, c) for c in ("structured", "dense")}
    batched = {
        "structured": [torch.stack(f) for f in zip(*(
            smoke._radius_inputs(rng, K, M, D, c)
            for c in ("structured", "ties", "all_invalid", "all_valid")))],
        "dense": [torch.stack(f) for f in zip(*(
            smoke._radius_inputs(rng, K, M, D, "dense") for _ in range(4)))],
    }

    def ms(fn):
        try:
            return smoke.time_ms(fn)
        except Exception as e:  # noqa: BLE001 - an older checkout may refuse a shape
            print(f"{root}: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
            return None

    top2 = {}
    rng2 = np.random.default_rng(1)
    for c in ("structured", "all_valid"):
        tq, _, _, tdb, _, tvdb = smoke._radius_inputs(rng2, K, M, D, c)
        top2[c] = (tdb, tvdb, tq)
    tdb, tvdb, tq = top2["all_valid"]
    low = tvdb.clone()
    low[RECOVERY_VALID_ROWS:] = False
    top2["low_slots"] = (tdb, low, tq)

    q, uvq, vq, db, uvdb, vdb = single["structured"]
    one = torch.zeros(1, device="cuda")
    res = dict(
        root=os.path.relpath(root, REPO),
        radius_match=ms(lambda: cuda_matching.radius_match(*single["structured"], **kw)),
        radius_match_dense=ms(lambda: cuda_matching.radius_match(*single["dense"], **kw)),
        radius_match_batched=ms(lambda: cuda_matching.radius_match_batched(
            *batched["structured"], **kw)),
        radius_match_batched_dense=ms(lambda: cuda_matching.radius_match_batched(
            *batched["dense"], **kw)),
        radius_empty_map=ms(lambda: cuda_matching.radius_match(
            q, uvq, vq, db[:0], uvdb[:0], vdb[:0], **kw)),
        radius_one_item=ms(lambda: cuda_matching.radius_match(
            q, uvq, vq, db[:64], uvdb[:64], vdb[:64], **kw)),
        one_element_add=ms(lambda: one.add_(1.0)),
        top2_match=ms(lambda: cuda_matching.top2_match(*top2["structured"])),
        top2_match_all_valid=ms(lambda: cuda_matching.top2_match(*top2["all_valid"])),
        top2_low_slots=ms(lambda: cuda_matching.top2_match(*top2["low_slots"])),
        top2_empty_map=ms(lambda: cuda_matching.top2_match(
            db[:0], vdb[:0], top2["structured"][2])),
    )
    res["top2_trace"] = device_activities(lambda: cuda_matching.top2_match(*top2["structured"]))
    return res


def device_activities(fn):
    """[name, device µs] of every device activity (kernel, memset, copy)
    of one call of `fn`, from a torch.profiler trace (after a warm call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.name[:80], e.time_range.end - e.time_range.start]
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        root = os.path.abspath(sys.argv[2])
        sys.path.insert(0, root)
        print(json.dumps(time_root(root)), flush=True)
        return 0
    roots = sys.argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                              capture_output=True, text=True, timeout=600)
        sys.stderr.write(proc.stderr)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(f"FAIL: {root} exited {proc.returncode}", file=sys.stderr, flush=True)
            rc = 1
            continue
        print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "unknown", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
