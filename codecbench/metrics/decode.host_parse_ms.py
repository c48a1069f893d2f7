"""The median host ms of one `decode` call's host parse over the measured
window: its `serve.parse` span, the C++ parser writing the batch's fields
into its ring (`codecbench/spans.py`). None where the calls record no such
span (the device parse)."""

from codecbench import spans


def read(run):
    return spans.median_ms(run, lambda c: spans.total_ms(c["serve.parse"])
                           if "serve.parse" in c else None)
