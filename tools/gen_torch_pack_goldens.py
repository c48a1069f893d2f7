#!/usr/bin/env python3
"""Writes the stored goldens of the lc3jax_torch pack slice, so that its
tests (tests/test_torch_pack.py) compile no JAX program:

    JAX_PLATFORMS=cpu python tools/gen_torch_pack_goldens.py

`tests/goldens/torch_pack.npz`:

- `bm_pk_{320,1200}`: the JAX bit model's `emit_pack` rows
  (`bitmodel_table_part(interpret=True, emit_pack=True)`, [5 * nt_pad, S])
  on the tuples stored in `tests/goldens/torch_encode.npz` (`bm_*`), at
  48 kHz / 10 ms with 320 and 1200 frame bits (rate flags 0 and 512);
- `mixed_*`, `lsb_*`: the two interpret-mode batches of
  tests/test_pallas_pack.py:80-89 (S = 128 at 8 kHz / 7.5 ms; mixed
  content at 40 B after 2 frames, LSB-heavy content at 80 B after 3):
  the JAX `encode_step(emit_pack=True)` fields of the last frame
  (`*_f_<name>`, `quant_pack_tables` in the JAX layout) and the bytes of
  `device_pack(interpret=True)` on them (`*_bytes`).
"""

from __future__ import annotations

import os
import sys
from functools import partial
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lc3jax.coding.pallas_pack import device_pack  # noqa: E402
from lc3jax.config import FrameDuration, Lc3Config  # noqa: E402
from lc3jax.dsp import pallas_bitmodel as PB  # noqa: E402
from lc3jax.dsp.encoder import encode_step, encoder_init  # noqa: E402

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
CFG8 = Lc3Config.new(8000, FrameDuration.MS7P5)
S = 128


def bitmodel_case() -> dict:
    g = np.load(ROOT / "tests" / "goldens" / "torch_encode.npz")
    c, gg, sym = (jnp.asarray(g[f"bm_{k}"].astype(np.int32)) for k in ("c", "g", "sym"))
    out = {}
    for nbits in (320, 1200):
        rate = 512 if nbits > 160 + CFG48.fs_ind * 160 else 0
        _, pk = PB.bitmodel_table_part(c, gg, sym, rate, CFG48.ne, interpret=True,
                                       emit_pack=True, lastnz=jnp.asarray(g["bm_lastnz"]))
        out[f"pk_{nbits}"] = np.asarray(pk)
    return out


def pcm_batch(cfg, seed: int, loud: bool) -> np.ndarray:
    """tests/test_pallas_pack.py:_fields' content, int16 [S, nf]."""
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.nf) / cfg.fs
    kinds = []
    for i in range(S):
        m = i % 4
        if m == 0:
            sig = np.zeros(cfg.nf) if not loud else 32000 * rng.standard_normal(cfg.nf)
        elif m == 1:
            sig = 28000 * rng.standard_normal(cfg.nf)
        elif m == 2:
            sig = 15000 * np.sin(2 * np.pi * (220 + 37 * (i % 11)) * t)
        else:
            sig = rng.normal(0, 30, cfg.nf)
        kinds.append(np.clip(sig, -32768, 32767).astype(np.int16))
    return np.stack(kinds)


def pack_case(cfg, nbytes: int, seed: int, loud: bool, steps: int) -> dict:
    pcm = pcm_batch(cfg, seed, loud)
    state = encoder_init(cfg, S)
    step = jax.jit(partial(encode_step, cfg, nbytes, emit_pack=True))
    for _ in range(steps):
        state, fields = step(state, pcm)
    fields = {k: np.asarray(v) for k, v in fields.items()}
    out = {f"f_{k}": v for k, v in fields.items()}
    jfields = {k: jnp.asarray(v) for k, v in fields.items()}
    out["bytes"] = np.asarray(device_pack(cfg, nbytes, jfields, interpret=True))
    return out


def main() -> None:
    out = {f"bm_{k}": v for k, v in bitmodel_case().items()}
    out.update({f"mixed_{k}": v for k, v in pack_case(CFG8, 40, 3, False, 2).items()})
    out.update({f"lsb_{k}": v for k, v in pack_case(CFG8, 80, 11, True, 3).items()})
    path = ROOT / "tests" / "goldens" / "torch_pack.npz"
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes, {len(out)} arrays)")


if __name__ == "__main__":
    main()
