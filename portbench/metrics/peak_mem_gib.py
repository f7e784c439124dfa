"""The device memory the window's peak held: the allocator's
``max_memory_allocated`` after ``reset_peak_memory_stats`` at the
window's start."""

UNIT = "GiB"
LAYER = "Device (H100)"
MOVES = "train_images_per_s"
SOURCE = "program_counter"


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2 ** 30
