"""Producer time per batch of the host input pipeline
(``data/pipeline.py``, on its own thread): gather, stack, pin and the
copy's enqueue, as the program counts it at each take in the profiled
slice (``input.produce_s`` over ``input.batches``).  Resident data has no
pipeline, and a program without the counters gives nothing to read."""

UNIT = "ms"
LAYER = "Input pipeline (data/pipeline.py)"
MOVES = "train_images_per_s"
SOURCE = "program_counter"


def read(run):
    if run.trace is None:
        return None
    try:
        from tpugan_torch.utils import tracing
    except ImportError:
        return None
    c = tracing.counters()
    if not c.get("input.batches"):
        return None
    return 1e3 * c["input.produce_s"] / c["input.batches"]
