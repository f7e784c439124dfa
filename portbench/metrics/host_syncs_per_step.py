"""Times a step makes the host wait for the device: the CUDA runtime's
synchronising calls (``spans.SYNCS``) inside the benchmark's span around
each call of ``step_fn`` in the profiled slice, over its steps, an exact
count.  Where the program counts its own blocking copies to the device
(``tpugan_torch.utils.tracing``'s ``h2d_blocking``), each of which
synchronises, and they outnumber the calls found, the matching has missed
some: nothing to read."""

from portbench import spans

UNIT = "syncs"
LAYER = "Train step (train/steps.py)"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(run):
    if run.trace is None or not run.trace.device or not run.slice_steps:
        return None
    found = len(spans.syncs_in_dispatch(run.trace))
    try:
        from tpugan_torch.utils import tracing
    except ImportError:  # a program without its own counters
        copies = 0
    else:
        copies = tracing.counters().get("h2d_blocking", 0)
    if copies > found:
        return None
    return found / run.slice_steps
