"""The set-up ms of the run's graph captures: the program's `step.capture`
spans (warm-up, capture and instantiation of each CUDA graph) summed, less
the kernels' build and load inside them (`setup.kernels_ms`;
`codecbench/spans.py`). None where nothing was captured (no card)."""

from codecbench import spans


def read(run):
    return spans.capture_ms(run)
