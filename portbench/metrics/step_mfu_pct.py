"""The whole step's share of the card's peak: the operations a step
needs (``flops.step_flops``, from the shapes, recomputation not counted)
times the window's unprofiled steps, over their seconds, over the peak of
the configuration's precision (bf16 989 TFLOP/s; fp32 at TF32's 495,
whatever route computes it)."""

from portbench import flops

UNIT = "%"
LAYER = "Whole step on the device"
MOVES = "train_images_per_s"
SOURCE = "host_clock"


def read(run):
    if not run.steps or not run.seconds:
        return None
    work = flops.step_flops(run.cfg["model"], run.batch, run.fused)
    return (100.0 * work * run.steps / run.seconds
            / flops.PEAK_FLOPS[run.precision])
