"""The median ms of one `decode` call's upload over the measured window: its
`serve.upload` span (the host array to the card) and its compiled step's
`step.copy_in` (into the graph's static input), the program's spans
(`codecbench/spans.py`)."""

from codecbench import spans


def read(run):
    return spans.upload_ms(run)
