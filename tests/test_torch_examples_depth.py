"""Example 15 of the port (``examples_torch/15_depth_fitting.py``) on the CPU at
``tests/test_examples.py``'s reduced flags: the mask and the depth fit (200 steps each, 24 x 24), holding the
example's own asserts (JAX's thresholds).

A file of its own: the soft rasteriser on the CPU is an eager chain of
about 250 elementwise passes over [pixels, faces] a step (JAX's XLA
fuses them), 50-140 s on one thread at these flags. Two torch threads:
eight ran each alone in about half a minute but, four such files at
once beside the other test workers, oversubscribed the cores (the
suite took twice as long).
"""

from torch_examples_run import run_example, torch_threads

RASTER_THREADS = 2


def test_example_runs(tmp_path):
    with torch_threads(RASTER_THREADS):
        run_example("15_depth_fitting", tmp_path)
