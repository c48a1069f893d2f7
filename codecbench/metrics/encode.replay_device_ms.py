"""The median device ms of one `encode` call's graph replay: the card's time
between the two CUDA events that the compiled step records around a
sampled replay (one call in 16) in the measured window, gaps between the
graph's nodes included, with no profiler running (`codecbench/spans.py`).
None without a card."""

from codecbench import spans


def read(run):
    return spans.replay_device_ms(run)
