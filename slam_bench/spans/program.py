"""The program's own span recorder (`vslam_tpu_torch.utils.profiling`),
read by `program.py`. A traced run loads the span files its cell's
metrics name, an untraced run none: loading this one switches the
recorder on for the rest of the run, the window and the traced chunk
(a program without the recorder records nothing). The attribute it names
is the recorder's switch, which nothing calls while a run is wrapped, so
it adds no span of the harness's own."""

from vslam_tpu_torch.utils import profiling

MODULE, ATTR = "vslam_tpu_torch.utils.profiling", "recording"

if hasattr(profiling, "start_recording"):
    profiling.start_recording()


def frames(a):
    return 0
