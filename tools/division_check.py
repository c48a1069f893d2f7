#!/usr/bin/env python3
"""Does a CUDA card divide an f32 tensor by a Python float as the CPU and
the oracle do?

    python3 tools/division_check.py

PyTorch's CUDA true-division kernel multiplies by the reciprocal when the
divisor is a CPU scalar (a Python number becomes one), so `x / c` on the
card may differ from the CPU's and the oracle's `x / c` by one ulp where c
is not a power of two. The encoder divides by each such constant as a
0-dim f32 tensor of its tables (`EncoderTables.divisors`: the bandwidth
detector's band widths, the SNS attack smoothing's 5 and 3, the TNS
quantiser's pi/17, the gain estimate's 20, the gain limit's 32767.625, the
gain adjustment's t2 - t1 and 48). For each of them, at every rate and
frame duration, a million f32 values from a seed are divided on the card
by the Python float and by the tables' tensor on the card, each held
against the CPU's division.
`5.0 / t` (Tensor.__rtruediv__, the SNS PVQ projection) is a reciprocal
times 5 on both devices, so it is held against numpy's division.

Then the witness rc = +-0.9829731 through the TNS quantiser's arithmetic
(asin in f64 rounded to f32, then / (pi/17), rounded half away from zero,
+ 8): the oracle's rc_i is 15 and 1; and the bandwidth detector on its
witness E_B (`bandwidth_witness`), whose oracle bw_ind is 0
(tests/test_torch_tns_enc.py pins both against lc3jax/ref).

Prints one line per constant and the witness, then one JSON line. Needs a
card; exits 1 without one. `chip_smoke.py` runs `site_rows` for its check.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

F32 = np.float32
N = 1_000_000
WITNESS = {0.9829731: 15, -0.9829731: 1}  # the oracle's rc_i
# the bandwidth detector's: band 0 (lines 41-49 at 48 kHz / 10 ms, width 9)
# folds its E_B / 9 to 19.999998, below the threshold 20, where the
# reciprocal multiply gives 20.0; with the other bands at 1.0 and a cutoff
# ratio of 1000 below band 0, the oracle's bw_ind is 0 (a card's reciprocal
# would take it to 4)
BW_WITNESS_BAND0 = [21.622806549072266, 20.81106185913086, 20.41261100769043, 14.240371704101562,
                    16.22295570373535, 19.988279342651367, 17.919572830200195, 24.783105850219727,
                    23.999235153198242]
BW_WITNESS_IND = 0


def bandwidth_witness() -> np.ndarray:
    """E_B [1, 64] f32 at 48 kHz / 10 ms, the bandwidth detector's witness."""
    e_b = np.ones((1, 64), F32)
    e_b[0, 41:50] = BW_WITNESS_BAND0
    e_b[0, 36] = 1000.0  # e_b[n - l_bw] / e_b[n] at n = 40, l_bw = 4
    return e_b


def values(seed: int = 0) -> np.ndarray:
    """N f32 values, sign random, magnitudes over 10^-3 .. 10^5."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(N) * 10 ** rng.uniform(-3, 5, N)).astype(F32)


def sites(dev) -> list:
    """[(label, c, t)]: each divisor of the encoder's tables at every rate
    and frame duration, once per value: the label names its sites, c is its
    value as a Python float and t the tables' 0-dim f32 tensor on `dev`."""
    import torch

    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.convert import encoder_tables

    names, tensors = {}, {}
    for dur in (FrameDuration.MS10, FrameDuration.MS7P5):
        for fs in (8000, 16000, 24000, 32000, 48000):
            for name, t in encoder_tables(Lc3Config.new(fs, dur), 1200, dev).divisors.items():
                assert t.dim() == 0 and t.dtype == torch.float32, name
                c = float(t)
                names.setdefault(c, set()).add(name)
                tensors.setdefault(c, t)
    return [(f"/ {c:.9g} ({', '.join(sorted(names[c]))})", c, tensors[c]) for c in sorted(names)]


def quantise(rc, step):
    """The TNS quantiser's arithmetic on an f32 tensor (rc_i)."""
    import torch

    q = torch.asin(rc.double()).float() / step
    qi = torch.where(q >= 0.0, (q + 0.5).to(torch.int64), -((-q + 0.5).to(torch.int64)))
    return qi + 8


def site_rows(dev) -> list:
    """[(label, differing values of the card's x / c with c a Python float,
    of x / t with t the tables' tensor, against the CPU's x / c)], for
    every divisor of `sites`."""
    import torch

    x_cpu = torch.as_tensor(values())
    x_dev = x_cpu.to(dev)
    rows = []
    for label, c, t in sites(dev):
        want = x_cpu / c
        rows.append((label, int(((x_dev / c).cpu() != want).sum()),
                     int(((x_dev / t).cpu() != want).sum())))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("division_check: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    out = {"card": card, "n": N, "sites": {}}
    for label, scalar, tensor in site_rows(dev):
        out["sites"][label] = {"python_float": scalar, "device_tensor": tensor}
        print(f"[division] {card}: {label}: {scalar} of {N} differ from the CPU with a Python float, "
              f"{tensor} with a device tensor", flush=True)
    # 5.0 / t: a reciprocal times 5 on both devices, against numpy's division
    v = np.abs(values(1)) + F32(1e-3)
    want = F32(5.0) / v
    for name, d in (("cpu", "cpu"), ("cuda", dev)):
        got = (5.0 / torch.as_tensor(v, device=d)).cpu().numpy()
        full = (torch.full((N,), 5.0, device=d) / torch.as_tensor(v, device=d)).cpu().numpy()
        out["sites"][f"5.0 / t on {name}"] = {"rtruediv": int((got != want).sum()),
                                               "full_like": int((full != want).sum())}
        print(f"[division] {card}: 5.0 / t on {name}: {int((got != want).sum())} of {N} differ "
              f"from numpy's division; torch.full(5.0) / t: {int((full != want).sum())}", flush=True)
    rc = torch.tensor(list(WITNESS), dtype=torch.float32)
    wit = {"oracle": list(WITNESS.values())}
    step = float(F32(np.pi / 17.0))
    for name, d in (("cpu", "cpu"), ("cuda", dev)):
        step_t = torch.tensor(step, dtype=torch.float32, device=d)
        wit[f"{name} python float"] = quantise(rc.to(d), step).cpu().tolist()
        wit[f"{name} device tensor"] = quantise(rc.to(d), step_t).cpu().tolist()
    out["witness"] = wit
    print(f"[division] {card}: witness rc = +-0.9829731, rc_i: {wit}", flush=True)
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.convert import encoder_tables
    from lc3jax_torch.dsp.encoder import bandwidth_detect

    e_b = torch.as_tensor(bandwidth_witness())
    band0 = torch.as_tensor(BW_WITNESS_BAND0)
    bw = {"oracle": BW_WITNESS_IND}
    for name, d in (("cpu", "cpu"), ("cuda", dev)):
        tab = encoder_tables(Lc3Config.new(48000, FrameDuration.MS10), 1200, d)
        bw[f"{name} bandwidth_detect"] = int(bandwidth_detect(tab, e_b.to(d))[0][0])
        quiet = {}
        for key, div in (("python float", 9.0), ("device tensor", tab.divisors["bandwidth_width_0"])):
            q = torch.zeros((), device=d)
            for v in band0.to(d) / div:
                q = q + v
            quiet[key] = float(q)
        bw[f"{name} band 0 fold"] = quiet
    out["bandwidth_witness"] = bw
    print(f"[division] {card}: bandwidth witness: {bw}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
