#!/usr/bin/env python3
"""Counts, on the CPU, the PyTorch ops that the two TNS kernel wrappers'
CUDA paths issue beside their kernel launch: each op is a launch on the
card, on top of the kernel's own.

    python3 tools/count_wrapper_ops.py [--tree DIR]

A wrapper sends a CPU tensor to its plain version, so the CUDA path never
runs here. This takes each wrapper's source (`dsp/tns_kernel.py:
tns_synthesis`, `dsp/tns_enc_kernel.py:tns_analysis`) from the checkout at
--tree (default: this one; an older commit unpacked with `git archive`
compares), drops its device branches, launch counter and `_build.launch`
call, and runs what is left on CPU tensors at 48 kHz / 10 ms, S = 4, under
a TorchDispatchMode that records every aten op that is neither a view nor
an allocation. Prints one line per wrapper: the count and the ops.
"""

from __future__ import annotations

import argparse
import inspect
import re
import sys
import textwrap
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# views, metadata and allocations: no kernel on the card
NO_LAUNCH = re.compile(r"^(view|_unsafe_view|_reshape_alias|reshape|t|transpose|select|slice|"
                       r"unsqueeze|squeeze|expand|as_strided|permute|alias|split_with_sizes|"
                       r"unbind|empty|new_empty|empty_strided|detach|lift_fresh|is_contiguous|sym_)")


def cuda_path(fn):
    """fn's body as it runs for a CUDA tensor, less the launch itself."""
    lines, out, skip = textwrap.dedent(inspect.getsource(fn)).splitlines(), [], 0
    for ln in lines:
        s = ln.strip()
        if skip:
            skip -= 1
        elif s.startswith(('if x.device.type == "cpu"', 'if x.device.type != "cuda"')):
            skip = 1
        elif not s.startswith("global "):
            out.append(ln)
    body = re.sub(r"_build\.launch\((.|\n)*?\)\n", "pass\n", "\n".join(out) + "\n")
    body = re.sub(r"\n\s*\w*launches \+= 1", "", body)
    ns = dict(fn.__globals__)
    exec(body, ns)
    return ns[fn.__name__]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="checkout whose wrappers to count")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.convert import decoder_tables, encoder_tables
    from lc3jax_torch.dsp import tns_enc_kernel, tns_kernel

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if not NO_LAUNCH.match(name):
                self.names.append(name)
            return func(*args, **(kwargs or {}))

    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    S, rng = 4, np.random.default_rng(0)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32))  # noqa: E731
    x = torch.as_tensor(rng.standard_normal((S, cfg.ne)).astype(np.float32))
    bw, ro, ri = i32(rng.integers(0, 5, S)), i32(rng.integers(0, 9, (S, 2))), i32(rng.integers(0, 17, (S, 16)))
    dt, et = decoder_tables(cfg, 1200), encoder_tables(cfg, 1200)
    cases = ((tns_kernel.tns_synthesis, (dt, x, bw, ro, ri)),
             (tns_enc_kernel.tns_analysis, (x, et.tns_bounds[bw.long()], ro, i32(np.full(S, 2)),
                                            et.tns_sin[ri.long()])))
    for fn, a in cases:
        with Ops() as ops:
            cuda_path(fn)(*a)
        print(f"{args.tree}: {fn.__name__}: {len(ops.names)} ops beside the kernel {ops.names}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
