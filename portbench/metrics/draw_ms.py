"""Host time a step spends drawing its random numbers: the program's span
``tpugan_torch.step.draws`` (``train/steps.py``: the threefry splits and
draws on the host and their blocking copies to the device) in the
profiled slice, over its steps.  A program without the span gives
nothing to read."""

from portbench import spans

UNIT = "ms"
LAYER = "RNG draws (sample/threefry.py, train/steps.py)"
MOVES = "train_images_per_s"
SOURCE = "program_span"


def read(run):
    if run.trace is None or not run.slice_steps:
        return None
    s = spans.span_seconds(run.trace, "step.draws")
    return None if s is None else 1e3 * s / run.slice_steps
