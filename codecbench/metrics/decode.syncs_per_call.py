"""The host's reads of a device value (each a wait for the card) over the
coder's `decode` calls, the program's counters `host_syncs` and `calls`
(`codecbench/spans.py`)."""

from codecbench import spans


def read(run):
    return spans.syncs_per_call(run)
