"""Host time a step spends in its optimizer updates: the program's spans
``tpugan_torch.step.d_update`` and ``tpugan_torch.step.g_update``
(``train/steps.py``: the gradients' all-reduce under a mesh, the LR, the
optimizer's step, the clip, G's EMA) in the profiled slice, over its
steps.  A program without the spans gives nothing to read."""

from portbench import spans

UNIT = "ms"
LAYER = "Optimizer and EMA (train/state.py)"
MOVES = "train_images_per_s"
SOURCE = "program_span"


def read(run):
    if run.trace is None or not run.slice_steps:
        return None
    parts = [spans.span_seconds(run.trace, n)
             for n in ("step.d_update", "step.g_update")]
    if all(p is None for p in parts):
        return None
    return 1e3 * sum(p or 0.0 for p in parts) / run.slice_steps
