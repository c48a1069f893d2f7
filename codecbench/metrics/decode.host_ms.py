"""The median host ms of one `decode` call over the measured window not spent
waiting on the card: its `serve.decode` span less its `serve.fetch` (the
program's spans, `codecbench/spans.py`)."""

from codecbench import spans


def read(run):
    return spans.host_ms(run)
