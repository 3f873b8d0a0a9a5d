"""The depth network's attention FLOPs (4 N^2 64 a head and block,
`da2_flops`) over the device time of its attention kernels in the traced
chunk, against the H100's 989 TFLOP/s bf16 (%)."""

import re

from slam_bench import da2_flops
from slam_bench.metrics.depth_ms import depth_records
from slam_bench.readers import H100_BF16_FLOPS

SPANS = ("frontend", "depth")
# Scaled-dot-product attention kernels: flash, memory-efficient (fmha) and
# cuDNN's.
ATTENTION = re.compile(r"flash|fmha|attention|sdpa", re.IGNORECASE)


def read(run):
    recs = depth_records(run)
    if recs is None:
        return None
    flops = sum(k["frames"] * da2_flops.attention_flops_per_frame(k["height"], k["width"],
                                                                  k["input_size"])
                for k, *_ in recs)
    device_s = sum(float((e - s)[i]) for _, s, e, names in recs
                   for i, n in enumerate(names) if ATTENTION.search(n)) / 1e9
    return 100.0 * flops / device_s / H100_BF16_FLOPS if device_s > 0 else None
