"""Host time a step waits for its batch from the host input pipeline:
the benchmark's span around taking the next batch, over the window's
unprofiled steps.  Resident data has no pipeline: nothing to read."""

UNIT = "ms"
LAYER = "Input pipeline (data/pipeline.py)"
MOVES = "train_images_per_s"
SOURCE = "host_clock"


def read(run):
    if run.feed != "pipeline" or not run.steps:
        return None
    return 1e3 * run.spans["input"] / run.steps
