"""One reader a per-layer metric, found by its file's name: ``UNIT``,
``LAYER`` (as ``PERF.md``'s list of layers names it), ``MOVES`` (the
end-to-end metric it should move), ``SOURCE``, and ``read(run)``, which
returns the number from a ``harness.Run`` or None where the run has
nothing for it to read."""
