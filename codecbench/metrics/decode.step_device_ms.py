"""The card's busy time a batch in the traced sub-window, in ms: the union
of its kernel, copy and fill spans over the sub-window's batches."""


def read(run):
    p = run.profile
    return p.busy_ms / p.batches
