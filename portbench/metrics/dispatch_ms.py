"""Host time a step spends inside ``Trainer.step_fn``: the benchmark's
span around each call (no synchronise inside), summed over the window's
unprofiled calls and divided by their steps.  It reads near the step
time where the host sets the pace."""

UNIT = "ms"
LAYER = "Trainer loop (train/trainer.py)"
MOVES = "train_images_per_s"
SOURCE = "host_clock"


def read(run):
    if not run.steps:
        return None
    return 1e3 * run.spans["dispatch"] / run.steps
