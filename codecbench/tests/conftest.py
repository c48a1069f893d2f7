"""The benchmark's own tests: on the CPU, its reference against the
repository's goldens, its corpus, the isolation of a run from JAX, each
cell's loop at a few streams, and the check that decides `correct`
against the control and planted faults. Run them with

    python -m pytest codecbench/tests -q

Tests marked `card` need a CUDA card; each decides that inside itself and
skips here with a reason."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
