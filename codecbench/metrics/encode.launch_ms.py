"""The median host ms of one `encode` call's graph replay over the measured
window: its compiled step's `step.replay` span, the launch of the CUDA
graph (`codecbench/spans.py`)."""

from codecbench import spans


def read(run):
    return spans.launch_ms(run)
