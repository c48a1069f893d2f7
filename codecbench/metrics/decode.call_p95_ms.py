"""The 95th percentile, in ms, of one `decode` call over every batch of the
measured window (host bytes in, host PCM out), each call timed between two
CUDA events on the card's idle stream, or on the host's clock without a
card. A run whose window timed no call reads nothing."""

import numpy as np


def read(run):
    if run.direction != "decode" or len(run.call_ms) == 0:
        return None
    return float(np.percentile(run.call_ms, 95))
