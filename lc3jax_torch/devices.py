"""Where the port's state lives: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing CUDA where no card is present: the entry
    points and state constructors default to the card and raise instead of
    carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lc3jax_torch: no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
