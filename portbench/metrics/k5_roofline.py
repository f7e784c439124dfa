"""Kernel 5 (conv + BatchNorm statistics, ``ops/cuda_conv_stats.py``) as
a share of its roofline: the sum over its launches in the profiled slice
of each launch's least time (``flops.least_seconds`` of the layer's
shapes, the work counted once) over the sum of the device time of its
kernels (the conv tiles, the statistics' reduce and, on the TF32 route,
the weight split), matched by name.

A launch's layer is known from the step: every D forward runs each of
D's BatchNorm layers once (2 forwards a FusedProp step, 3 an alternating
one).  The launches the trace shows, the program's own counter
(``cuda_conv_stats.launches``) and that count must agree; where they do
not, or no launch ran, there is nothing to read."""

from portbench import flops

UNIT = "%"
LAYER = "Kernels (ops/cuda_conv_stats.py)"
MOVES = "train_images_per_s"
SOURCE = "device_trace"

LAUNCH = ("conv_stats_kernel", "conv_stats_f32_kernel")
PARTS = LAUNCH + ("stats_reduce_kernel", "split_weight_tf32")


def read(run):
    if run.trace is None or not run.slice_steps:
        return None
    mine = [(n, s, e) for n, s, e in run.trace.kernels()
            if any(p in n for p in PARTS)]
    launched = sum(1 for n, _, _ in mine if any(p in n for p in LAUNCH))
    layers = flops.conv_stats_layers(run.cfg["model"])
    forwards = (2 if run.fused else 3) * run.slice_steps
    expected = forwards * len(layers)
    if not launched or not (launched == expected
                            == run.slice_launches.get("conv_stats")):
        return None
    least = forwards * sum(
        flops.least_seconds(*flops.conv_stats_work(
            run.batch, side, cin, cout, run.precision), run.precision)
        for _, side, cin, cout in layers)
    return 100.0 * least / sum(e - s for _, s, e in mine)
