#!/usr/bin/env python3
"""Writes the stored goldens of the lc3jax_torch encoder and chip_smoke.py,
so that neither compiles JAX nor imports the lc3jax package:

    JAX_PLATFORMS=cpu python tools/gen_torch_encode_goldens.py

- `lc3jax_torch/data/exp2f.npz`: glibc's exp2f table, shift and cubic,
  extracted once from this host's libm (`lc3jax.dsp.libmexact._extract`),
  the libm the oracle's goldens were made with. The port reads this file and
  never scans the libm of the host it runs on.
- `tests/goldens/torch_encode.npz` (S = 128 streams unless stated, inputs
  from `np.random.default_rng`):
  - `sns_*`: `sns_pvq_pallas(interpret=True)` on random rotated residuals
    (`sns_t2rot`), and `sns_analysis(use_pallas=False)` on random spectra
    and band energies (`sns_in_*` -> `sns_out_*`), at 48 kHz / 10 ms;
  - `tns_*`: `tns_analysis_batch` through its XLA path and through its
    Pallas path in interpret mode, on spectra with correlated lines, and
    the two Pallas entries alone (`tns_autocorr_pallas`,
    `tns_analysis_pallas`, interpret mode), at 48 kHz / 10 ms, 1200 bits;
    the Pallas spectra are stored as f32 ULP offsets from `tns_xla_x`
    (`tns_pallas_ulps`, `tns_lattice_ulps`);
  - `bm_*`: `bitmodel_table_part(interpret=True)` on the tuples of random
    quantized spectra, and `bit_consumption(use_pallas=False)` on them, at
    320 and 1200 frame bits;
  - `step48_*`, `step32_*`: `encode_step` at 48 kHz / 10 ms / 150 B and
    32 kHz / 7.5 ms / 60 B (S = 4): the state after 3 warm-up frames
    (`init_*`), the PCM of the next 3 frames, their fields (`f{t}_*`) and
    the final state (`final_*`).
- `tests/goldens/torch_bench_content.npz`: the four signals of bench.py's
  batch over 12 frames at 48 kHz (int16), their oracle frames at 150 B with
  frame 5 of content 2 set to 255 (a corrupt frame), and the oracle decode
  of those frames.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lc3jax.config import FrameDuration, Lc3Config  # noqa: E402
from lc3jax.dsp import encoder as E  # noqa: E402
from lc3jax.dsp import libmexact  # noqa: E402
from lc3jax.dsp import pallas_bitmodel as PB  # noqa: E402
from lc3jax.dsp import pallas_sns as PS  # noqa: E402
from lc3jax.dsp import pallas_tns as PT  # noqa: E402
from lc3jax.ref.decoder import Lc3Decoder  # noqa: E402
from lc3jax.ref.encoder import Lc3Encoder  # noqa: E402

F32 = np.float32
S = 128
CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
CFG32 = Lc3Config.new(32000, FrameDuration.MS7P5)


def exp2f_table() -> None:
    tab, shift, poly = libmexact._extract()
    path = ROOT / "lc3jax_torch" / "data" / "exp2f.npz"
    np.savez(path, tab=tab, shift=np.float64(shift), poly=poly)
    print(f"wrote {path}")


def sns_case() -> dict:
    p = E.encoder_params(CFG48)
    rng = np.random.default_rng(21)
    t2rot = (rng.standard_normal((S, 16)) * 10 ** rng.uniform(-1, 0.7, (S, 1))).astype(F32)
    t2rot[0, 10:] = 0.0  # set B empty
    y_sel, y0s, xq_sel, shape_j, gind, g_sel = PS.sns_pvq_pallas(jnp.asarray(t2rot),
                                                                interpret=True)
    x = (rng.standard_normal((S, CFG48.ne)) * 10 ** rng.uniform(-2, 4, (S, 1))).astype(F32)
    e_b = np.abs(rng.standard_normal((S, CFG48.nb)) * 10 ** rng.uniform(-6, 6, (S, 1))).astype(F32)
    e_b[1] = 0.0
    attack = rng.integers(0, 2, S).astype(bool)
    xs, fields = E.sns_analysis(p, jnp.asarray(x), jnp.asarray(e_b), jnp.asarray(attack),
                                use_pallas=False)
    out = dict(t2rot=t2rot, y_sel=y_sel, y0s=y0s, xq_sel=xq_sel, shape_j=shape_j, gind=gind,
               g_sel=g_sel, in_x=x, in_e_b=e_b, in_attack=attack, out_x=xs)
    out.update({f"out_{k}": v for k, v in fields.items()})
    return out


def tns_spectra(rng) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Spectra whose lines are correlated (so most frames turn TNS on), with
    white and silent rows; random bandwidths; a few near-Nyquist rows."""
    w = rng.standard_normal((S, CFG48.ne))
    rho = rng.uniform(-0.95, 0.95, (S, 1))
    x = np.zeros_like(w)
    for n in range(CFG48.ne):
        x[:, n] = (rho[:, 0] * x[:, n - 1] if n else 0) + w[:, n]
    x[::5] = w[::5]  # white rows
    x *= 10 ** rng.uniform(0, 3, (S, 1))
    x[3] = 0.0
    bw = rng.integers(0, 5, S).astype(np.int32)
    nn = rng.uniform(size=S) < 0.1
    return x.astype(F32), bw, nn


def tns_case() -> dict:
    p = E.encoder_params(CFG48)
    rng = np.random.default_rng(22)
    x, bw, nn = tns_spectra(rng)
    xla_x, xla_f = E.tns_analysis_batch(p, jnp.asarray(x), jnp.asarray(bw), 1200,
                                        jnp.asarray(nn), use_pallas=False)
    ac_orig, an_orig = PT.tns_autocorr_pallas, PT.tns_analysis_pallas
    with mock.patch.object(PT, "tns_autocorr_pallas",
                           lambda x, sub, interpret=False: ac_orig(x, sub, interpret=True)), \
         mock.patch.object(PT, "tns_analysis_pallas",
                           lambda *a, interpret=False: an_orig(*a, interpret=True)):
        pal_x, _ = E.tns_analysis_batch(p, jnp.asarray(x), jnp.asarray(bw), 1200,
                                        jnp.asarray(nn), use_pallas=True)
    sub = np.asarray(p.tns_sub, np.int32)[bw]
    bounds = np.asarray(p.tns_bounds, np.int32)[bw]
    ac = PT.tns_autocorr_pallas(jnp.asarray(x), jnp.asarray(sub), interpret=True)
    sin = np.sin(np.pi / 17.0 * (np.arange(17, dtype=np.float64) - 8.0)).astype(F32)
    rc_i = np.asarray(xla_f["rc_i"])
    rc_q = np.where(rc_i == 8, F32(0), sin[np.clip(rc_i, 0, 16)]).astype(F32)
    num_filters = np.asarray(xla_f["num_tns_filters"])
    rc_order = np.asarray(xla_f["rc_order"])
    lat = PT.tns_analysis_pallas(p, jnp.asarray(x), jnp.asarray(bounds), jnp.asarray(rc_order),
                                 jnp.asarray(num_filters), jnp.asarray(rc_q), interpret=True)
    # the Pallas outputs as f32 ULP offsets from the XLA path's: all zero
    # where they agree, so the file stays small
    xla_bits = np.asarray(xla_x, F32).view(np.int32)
    ulps = lambda a: np.asarray(a, F32).view(np.int32) - xla_bits  # noqa: E731
    out = dict(x=x, bw=bw, nn=nn, xla_x=xla_x, pallas_ulps=ulps(pal_x), sub=sub, ac=ac,
               bounds=bounds, rc_q=rc_q, lattice_ulps=ulps(lat))
    out.update({f"xla_{k}": v for k, v in xla_f.items()})
    return out


def tuple_symbols(x_q: np.ndarray):
    """Context, ladder depth and final symbol per tuple, and lastnz
    (lc3jax/dsp/encoder.py:1145-1166), in numpy."""
    n_s, ne = x_q.shape
    pairs = x_q.reshape(n_s, ne // 2, 2).astype(np.int64)
    nz = (pairs != 0).any(2)
    last = np.where(nz.any(1), ne // 2 - 1 - np.argmax(nz[:, ::-1], 1), -1)
    lastnz = np.maximum(2 * (last + 1), 2)
    a0, b0 = np.abs(pairs[:, :, 0]), np.abs(pairs[:, :, 1])
    g = (np.maximum(a0, b0)[:, :, None] >= (4 << np.arange(14))).sum(2)
    lev = np.minimum(g, 3)
    a_f, b_f = a0 >> g, b0 >> g
    sym = np.clip(a_f + 4 * b_f, 0, 16)
    t = np.where(lev <= 1, 1 + (a_f + b_f) * (lev + 1), 12 + lev)
    t1 = np.pad(t[:, :-1], ((0, 0), (1, 0)))
    t2 = np.pad(t[:, :-2], ((0, 0), (2, 0)))
    return ((t2 & 15) * 16 + t1).astype(np.int32), g.astype(np.int32), \
        sym.astype(np.int32), lastnz.astype(np.int32)


def bitmodel_case() -> dict:
    p = E.encoder_params(CFG48)
    rng = np.random.default_rng(23)
    mag = (rng.standard_normal((S, CFG48.ne)) * 3).astype(np.int64)
    x_q = np.clip(mag * (1 << rng.integers(0, 15, (S, CFG48.ne))) // 8, -32768, 32767)
    x_q[rng.integers(100, 400, S)[:, None] <= np.arange(CFG48.ne)] = 0  # ragged lastnz
    x_q[0] = 0
    x_q = x_q.astype(np.int32)
    c, g, sym, lastnz = tuple_symbols(x_q)
    out = dict(x_q=x_q.astype(np.int16), c=c.astype(np.uint8), g=g.astype(np.uint8),
               sym=sym.astype(np.uint8), lastnz=lastnz)
    for nbits in (320, 1200):
        rate = 512 if nbits > 160 + CFG48.fs_ind * 160 else 0
        est = PB.bitmodel_table_part(jnp.asarray(c), jnp.asarray(g), jnp.asarray(sym), rate,
                                     CFG48.ne, interpret=True, lastnz=jnp.asarray(lastnz))
        out[f"table_{nbits}"] = np.asarray(est).astype(np.int32)
        nspec = np.full(S, nbits - 300, np.int32)
        bc = E.bit_consumption(p, jnp.asarray(x_q), nbits, jnp.asarray(nspec), use_pallas=False)
        for k in ("lastnz", "lastnz_trunc", "nbits_est", "nbits_trunc", "nbits_lsb"):
            out[f"bc_{nbits}_{k}"] = np.asarray(bc[k])
    return out


def leaves(st) -> dict:
    out = {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)
           if f.name != "ltpf"}
    out.update({f"ltpf_{f.name}": np.asarray(getattr(st.ltpf, f.name))
                for f in dataclasses.fields(st.ltpf)})
    return out


def signals(cfg, T: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(T * cfg.nf) / cfg.fs
    sig = [
        8000 * np.sin(2 * np.pi * 180 * t),
        5000 * np.sin(2 * np.pi * 240 * t) + 200 * rng.standard_normal(len(t)),
        1500 * rng.standard_normal(len(t)),
        7000 * np.sin(2 * np.pi * 130 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)),
    ]
    return np.stack(sig).astype(np.int16).reshape(4, T, cfg.nf).transpose(1, 0, 2)


def step_case(cfg, nbytes: int, seed: int) -> dict:
    pcm = signals(cfg, 6, seed)  # [T, 4, nf]
    step = jax.jit(lambda st, x: E.encode_step(cfg, nbytes, st, x))
    st = E.encoder_init(cfg, 4)
    for t in range(3):
        st, _ = step(st, jnp.asarray(pcm[t]))
    out = {f"init_{k}": v for k, v in leaves(st).items()}
    out["pcm"] = pcm[3:]
    for t in range(3):
        st, fields = step(st, jnp.asarray(pcm[3 + t]))
        out.update({f"f{t}_{k}": np.asarray(v) for k, v in fields.items()})
    out.update({f"final_{k}": v for k, v in leaves(st).items()})
    return out


def bench_content() -> dict:
    """chip_smoke's content: bench.py's four signals, 12 frames at 48 kHz."""
    T = 12
    rng = np.random.default_rng(0)
    t = np.arange(T * CFG48.nf) / CFG48.fs
    n = len(t)
    sig = np.stack([
        (8000 * np.sin(2 * np.pi * 220 * t)).astype(np.int16),
        (3000 * np.sin(2 * np.pi * 997 * t) + 500 * rng.standard_normal(n)).astype(np.int16),
        (1500 * rng.standard_normal(n)).astype(np.int16),
        (6000 * np.sin(2 * np.pi * 97 * t)).astype(np.int16),
    ]).reshape(4, T, CFG48.nf)
    frames = np.zeros((4, T, 150), np.uint8)
    for c in range(4):
        enc = Lc3Encoder(1, CFG48.n_ms, CFG48.fs)
        for f in range(T):
            frames[c, f] = np.frombuffer(bytes(enc.encode_frame(0, sig[c, f], 150)), np.uint8)
    encoded = frames.copy()
    frames[2, 5] = 255
    pcm = np.zeros((4, T, CFG48.nf), np.int16)
    for c in range(4):
        dec = Lc3Decoder(1, CFG48.n_ms, CFG48.fs)
        for f in range(T):
            pcm[c, f] = dec.decode_frame(16, 0, bytes(frames[c, f]))
    return dict(pcm_in=sig, encoded=encoded, frames=frames, pcm_out=pcm)


def main() -> None:
    exp2f_table()
    out = {}
    for tag, fn in (("sns", sns_case), ("tns", tns_case), ("bm", bitmodel_case)):
        out.update({f"{tag}_{k}": np.asarray(v) for k, v in fn().items()})
    out.update({f"step48_{k}": np.asarray(v) for k, v in step_case(CFG48, 150, 31).items()})
    out.update({f"step32_{k}": np.asarray(v) for k, v in step_case(CFG32, 60, 32).items()})
    path = ROOT / "tests" / "goldens" / "torch_encode.npz"
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes, {len(out)} arrays)")
    path = ROOT / "tests" / "goldens" / "torch_bench_content.npz"
    np.savez_compressed(path, **bench_content())
    print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
