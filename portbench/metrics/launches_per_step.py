"""Device kernels a train step launches: the kernels in the profiled
slice (copies and fills not counted) over its steps, an exact count."""

UNIT = "launches"
LAYER = "Train step (train/steps.py)"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(run):
    if run.trace is None or not run.trace.device or not run.slice_steps:
        return None
    return len(run.trace.kernels()) / run.slice_steps
