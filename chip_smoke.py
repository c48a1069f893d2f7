#!/usr/bin/env python3
"""Smoke run of lc3jax_torch on one CUDA card: build, check, decode, time.

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero before the
last line):

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: the three kernels from lc3jax_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (48 kHz / 10 ms / 150 B, S = 2048): parse on
   encoded frames mixed with random garbage (all 19 fields equal), TNS on
   random lattices (equal), LTPF on random-state stress inputs (<= 1e-3);
4. slice: BatchDecoder(48 kHz, S = 2048, 150 B, cuda).decode over T frames
   of mixed content with one corrupt frame; PCM within 1 LSB and >= 100 dB
   SNR of the oracle decoder (lc3jax.ref) on each distinct stream; every
   kernel's launch count equals T;
5. corpus: the six corpus geometries and stream50 (tests/goldens) through
   the port on the card, same bound against the stored oracle PCM;
6. times: CUDA events after warm-up, median of 20: the fused step and each
   kernel against its plain version.

Then one JSON line with the kernels, and last the device line. Uses no JAX:
the references are the numpy oracle lc3jax.ref and the .npz goldens.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
S_MAIN = 2048
NBYTES = 150
T_FRAMES = 12
REPS = 20
CORPUS = ["48000_10ms_120", "48000_10ms_20", "48000_10ms_400", "44100_7.5ms_100",
          "16000_10ms_60", "8000_10ms_40"]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def envelope(pcm: np.ndarray, want: np.ndarray) -> tuple[int, float]:
    """(max |error| in LSB, SNR in dB) of int16 PCM against the oracle."""
    err = pcm.astype(np.int64) - want.astype(np.int64)
    sig = float(np.sum(want.astype(np.float64) ** 2))
    snr = 10.0 * np.log10(sig / max(float(np.sum(err.astype(np.float64) ** 2)), 1.0))
    return int(np.abs(err).max()), snr


def check_envelope(name: str, pcm, want) -> str:
    max_lsb, snr = envelope(pcm, want)
    if max_lsb > 1 or (max_lsb > 0 and snr < 100.0):  # an exact match passes
        raise AssertionError(f"{name}: max {max_lsb} LSB, SNR {snr:.1f} dB (need <= 1, >= 100)")
    return f"{name}: max {max_lsb} LSB, SNR {snr:.1f} dB"


def content(cfg, T: int, rng) -> list[np.ndarray]:
    """The four signals of bench.py's batch, T frames long."""
    t = np.arange(T * cfg.nf) / cfg.fs
    n = len(t)
    return [
        (8000 * np.sin(2 * np.pi * 220 * t)).astype(np.int16),
        (3000 * np.sin(2 * np.pi * 997 * t) + 500 * rng.standard_normal(n)).astype(np.int16),
        (1500 * rng.standard_normal(n)).astype(np.int16),
        (6000 * np.sin(2 * np.pi * 97 * t)).astype(np.int16),
    ]


def encode_streams(cfg, signals, nbytes: int) -> np.ndarray:
    """Oracle-encoded frames [len(signals), T, nbytes]."""
    from lc3jax.ref.encoder import Lc3Encoder

    out = []
    for sig in signals:
        enc = Lc3Encoder(1, cfg.n_ms, cfg.fs)
        T = len(sig) // cfg.nf
        out.append([np.frombuffer(bytes(enc.encode_frame(0, sig[f * cfg.nf:(f + 1) * cfg.nf],
                                                          nbytes)), np.uint8)
                    for f in range(T)])
    return np.asarray(out, np.uint8)


def oracle_decode(cfg, frames: np.ndarray) -> np.ndarray:
    """Oracle PCM [T, nf] of one stream's frames [T, nbytes]."""
    from lc3jax.ref.decoder import Lc3Decoder

    dec = Lc3Decoder(1, cfg.n_ms, cfg.fs)
    return np.stack([dec.decode_frame(16, 0, bytes(f)) for f in frames])


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def ltpf_stress(p, S: int, seed: int, device):
    """Random-state LTPF inputs in the pattern of tests/test_pallas_ltpf.py."""
    import torch

    from lc3jax_torch.dsp.ltpf import LtpfState

    rng = np.random.default_rng(seed)
    H = p.num_mem_blocks * p.nf
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    st = LtpfState(
        hist_x=f(rng.standard_normal((S, H)) * 1000),
        hist_y=f(rng.standard_normal((S, H)) * 1000),
        c_num=f(rng.standard_normal((S, p.l_num + 1)) * 0.2),
        c_den=f(rng.standard_normal((S, p.l_den + 1)) * 0.2),
        p_int=torch.as_tensor(rng.integers(18, 855, S).astype(np.int32), device=device),
        p_fr=torch.as_tensor(rng.integers(0, 4, S).astype(np.int32), device=device),
        active=torch.as_tensor(rng.integers(0, 2, S).astype(bool), device=device),
    )
    x = f(rng.standard_normal((S, p.nf)) * 2000)
    active = torch.as_tensor(rng.integers(0, 2, S).astype(bool), device=device)
    pitch = torch.as_tensor(rng.integers(0, 512, S).astype(np.int32), device=device)
    return st, x, active, pitch


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from lc3jax.config import FrameDuration, Lc3Config
    from lc3jax_torch import _build
    from lc3jax_torch.coding import device as cdev
    from lc3jax_torch.coding import parse_kernel
    from lc3jax_torch.convert import decoder_tables
    from lc3jax_torch.dsp import decoder as D
    from lc3jax_torch.dsp import ltpf_kernel, tns_kernel
    from lc3jax_torch.dsp.ltpf import ltpf_pass_args
    from lc3jax_torch.serving import BatchDecoder

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("card", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
                f"{torch.cuda.device_count()} device(s)")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.lib()
    log("build", f"{_build.library_path().name} in {time.perf_counter() - t0:.1f} s "
                 f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")

    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    nbits = NBYTES * 8
    tab = decoder_tables(cfg, nbits, dev)
    rng = np.random.default_rng(0)

    # ---- 3. kernels against their plain versions, main-path shapes
    one = encode_streams(cfg, content(cfg, 1, rng), NBYTES)[:, 0]  # bench.py's 4 frames
    garbage = np.random.default_rng(1).integers(0, 256, (S_MAIN, NBYTES), dtype=np.uint8)
    mixed = np.where((np.arange(S_MAIN) % 2 == 0)[:, None], one[np.arange(S_MAIN) % 4], garbage)
    payloads = torch.as_tensor(mixed, device=dev)
    fk = cdev.device_parse(cfg, NBYTES, payloads)
    fp = cdev.device_parse_plain(cfg, NBYTES, payloads)
    torch.cuda.synchronize()
    errs = {"parse": 0.0}
    for f in dataclasses.fields(fk):
        a, b = getattr(fk, f.name), getattr(fp, f.name)
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
        errs["parse"] = max(errs["parse"], float(diff.max()))
        if a.dtype != b.dtype or bool(diff.any()):
            bad = diff.reshape(S_MAIN, -1).any(1).nonzero().flatten()[:8].tolist()
            raise AssertionError(f"parse kernel != plain on field {f.name}, streams {bad}")
    n_bad = int(fk.bad_frame.sum())
    if n_bad == 0 or bool(fk.bad_frame[0::2].any()):
        raise AssertionError(f"parse: unexpected bad-frame pattern ({n_bad} bad)")

    g = np.random.default_rng(2)
    x_t = torch.as_tensor((g.standard_normal((S_MAIN, cfg.ne)) * 1000).astype(np.float32), device=dev)
    bw_t = torch.as_tensor(g.integers(0, 5, S_MAIN).astype(np.int32), device=dev)
    ro_t = torch.as_tensor(g.integers(0, 9, (S_MAIN, 2)).astype(np.int32), device=dev)
    ri_t = torch.as_tensor(g.integers(0, 17, (S_MAIN, 16)).astype(np.int32), device=dev)
    tns_args = (tab, x_t, bw_t, ro_t, ri_t)
    yk = tns_kernel.tns_synthesis(*tns_args)
    yp = tns_kernel.tns_synthesis_plain(*tns_args)
    errs["tns"] = float((yk - yp).abs().max())
    if not torch.equal(yk, yp):
        raise AssertionError(f"tns kernel != plain, max abs {errs['tns']}")

    st, x_l, act_l, pi_l = ltpf_stress(tab.p, S_MAIN, 7, dev)
    lt_args = ltpf_pass_args(tab, st, x_l, act_l, pi_l)[0]
    ka, kb = ltpf_kernel.ltpf_both_passes(*lt_args)
    pa, pb = ltpf_kernel.ltpf_both_passes_plain(*lt_args)
    errs["ltpf"] = max(float((ka - pa).abs().max()), float((kb - pb).abs().max()))
    if errs["ltpf"] > 1e-3:
        raise AssertionError(f"ltpf kernel vs plain: max abs {errs['ltpf']} > 1e-3")
    log("kernels", f"parse: 19 fields equal ({n_bad}/{S_MAIN} bad frames); "
                   f"tns: equal (max abs {errs['tns']}); ltpf: max abs {errs['ltpf']} (<= 1e-3)")

    # ---- 4. the slice: BatchDecoder over T frames, S = 2048
    signals = content(cfg, T_FRAMES, rng)
    frames = encode_streams(cfg, signals, NBYTES)  # [4, T, nbytes]
    frames[2, 5] = 255  # a corrupt frame: PLC on every stream of content 2
    want = [oracle_decode(cfg, frames[c]) for c in range(4)]
    dec = BatchDecoder(cfg, S_MAIN, NBYTES, device="cuda")
    counters = (parse_kernel, tns_kernel, ltpf_kernel)
    for m in counters:
        m.launches = 0
    pcm = [dec.decode(frames[np.arange(S_MAIN) % 4, f]) for f in range(T_FRAMES)]
    launches = {"parse": parse_kernel.launches, "tns": tns_kernel.launches,
                "ltpf": ltpf_kernel.launches}
    pcm = np.stack(pcm, 1)  # [S, T, nf]
    if any(n != T_FRAMES for n in launches.values()):
        raise AssertionError(f"launch counts {launches} != {T_FRAMES} steps")
    if not all(np.array_equal(pcm[s], pcm[s % 4]) for s in range(S_MAIN)):
        raise AssertionError("streams with equal input decoded differently")
    # one envelope over the four distinct streams: alone, the quiet noise
    # stream (1500 rms) drops below 100 dB on a single 1-LSB flip in T frames
    per = [envelope(pcm[c], want[c]) for c in range(4)]
    lines = [check_envelope("contents 0-3", pcm[:4], np.stack(want))] + [
        f"content {c}: max {m} LSB, {int((pcm[c] != want[c]).sum())} flips, {snr:.1f} dB"
        for c, (m, snr) in enumerate(per)]
    if dec.metrics.plc_frames != S_MAIN // 4:
        raise AssertionError(f"plc_frames {dec.metrics.plc_frames} != {S_MAIN // 4}")
    log("slice", f"S={S_MAIN} T={T_FRAMES}: launches {launches}; plc_rate "
                 f"{dec.metrics.plc_rate:.6f}; " + "; ".join(lines))

    # ---- 5. corpus and stream50 on the card
    gold = ROOT / "tests" / "goldens"
    corpus = np.load(gold / "corpus.npz")
    s50 = np.load(gold / "stream50.npz")
    runs = [(k, *k.split("_"), corpus[k + "_payloads"], corpus[k + "_pcm_out"]) for k in CORPUS]
    runs.append(("stream50", "48000", "10ms", "120", s50["payloads"], s50["pcm_out"]))
    lines = []
    for name, fs, dur, _, pl, want_pcm in runs:
        c = Lc3Config.new(int(fs), FrameDuration.MS7P5 if dur == "7.5ms" else FrameDuration.MS10)
        d = BatchDecoder(c, 1, pl.shape[1], device="cuda")
        out = np.stack([d.decode(pl[f : f + 1])[0] for f in range(pl.shape[0])])
        lines.append(check_envelope(name, out, want_pcm))
    log("corpus", "; ".join(lines))

    # ---- 6. times (CUDA events, median of REPS after warm-up)
    pay = torch.as_tensor(frames[np.arange(S_MAIN) % 4, 0], device=dev)
    step_ms = cuda_ms(lambda: dec.decode_tensor(pay))
    fr = cdev.device_parse(cfg, NBYTES, pay)
    real_tns = (tab, D.pre_tns(tab, fr), fr.bandwidth, fr.rc_order, fr.rc_i)
    times = {
        "parse": (cuda_ms(lambda: parse_kernel.parse_frames_cuda(cfg, NBYTES, pay)),
                  cuda_ms(lambda: cdev.device_parse_plain(cfg, NBYTES, pay))),
        "tns": (cuda_ms(lambda: tns_kernel.tns_synthesis(*real_tns)),
                cuda_ms(lambda: tns_kernel.tns_synthesis_plain(*real_tns))),
        "ltpf": (cuda_ms(lambda: ltpf_kernel.ltpf_both_passes(*lt_args)),
                 cuda_ms(lambda: ltpf_kernel.ltpf_both_passes_plain(*lt_args))),
    }
    rt = S_MAIN * (cfg.nf / cfg.fs) / (step_ms / 1e3)
    log("times", f"{card}: fused step {step_ms:.4f} ms = {rt:.1f}x realtime "
                 f"(S={S_MAIN}, 48k/10ms/150B); " + "; ".join(
                     f"{k} kernel {a:.4f} ms vs plain {b:.4f} ms" for k, (a, b) in times.items()))
    log("done", f"{time.perf_counter() - t_start:.1f} s")

    src = "lc3jax_torch/csrc/"
    kernels = [
        {"name": "parse", "route": "cuda", "source": src + "parse.cu",
         "replaces": "lc3jax/coding/pallas_parse.py:597"},
        {"name": "tns_synthesis", "route": "cuda", "source": src + "tns_synthesis.cu",
         "replaces": "lc3jax/dsp/pallas_tns.py:226"},
        {"name": "ltpf_both_passes", "route": "cuda", "source": src + "ltpf.cu",
         "replaces": "lc3jax/dsp/pallas_ltpf.py:122"},
    ]
    for k, key in zip(kernels, ("parse", "tns", "ltpf")):
        k.update(launches=launches[key], max_abs_err=errs[key],
                 ms=times[key][0], plain_ms=times[key][1])
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
