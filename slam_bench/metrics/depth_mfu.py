"""The depth network's FLOPs (`da2_flops`) over its device time in the
traced chunk, against the H100's 989 TFLOP/s bf16 (%)."""


from slam_bench import da2_flops
from slam_bench.metrics.depth_ms import depth_records
from slam_bench.readers import H100_BF16_FLOPS

SPANS = ("frontend", "depth")


def read(run):
    recs = depth_records(run)
    if recs is None:
        return None
    flops = sum(k["frames"] * da2_flops.flops_per_frame(k["height"], k["width"], k["input_size"])
                for k, *_ in recs)
    device_s = sum(float((e - s).sum()) for _, s, e, _ in recs) / 1e9
    return 100.0 * flops / device_s / H100_BF16_FLOPS if device_s > 0 else None
