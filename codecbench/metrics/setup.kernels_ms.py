"""The set-up ms of the port's CUDA kernels: the program's `kernels.build`
span (nvcc, only where the hashed library was missing) and `kernels.load`
(the library loaded and its signatures set), summed (`codecbench/spans.py`).
None where no kernel was loaded (no card)."""

from codecbench import spans


def read(run):
    return spans.kernels_ms(run)
