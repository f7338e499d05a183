"""Example 14 of the port (``examples_torch/14_dataset_calibration.py``) on the CPU at
``tests/test_examples.py``'s reduced flags: the keypoint + mask fit (200 steps of a 40 x 40 soft silhouette), holding the
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
        run_example("14_dataset_calibration", tmp_path)
