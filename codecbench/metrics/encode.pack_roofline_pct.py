"""The pack kernel's share of its byte roofline, in percent: the least time
for the bytes a batch's range coding needs (`codecbench/bounds.py`, from
the configuration and the stream count) at the card's memory bandwidth,
over `pack_kernel`'s device time a batch in the traced sub-window."""

from codecbench import bounds


def read(run):
    ms = run.profile.kernel_total_ms("pack_kernel")
    if ms is None:
        return None
    return bounds.roofline_pct(bounds.coder_bytes(run.cfg, run.streams),
                               ms / run.profile.batches, run.device_name)
