"""The share of the profiled slice in which no operation ran on the
device: one minus the union of the device's operations over the slice's
span."""

UNIT = "%"
LAYER = "Device (H100)"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
