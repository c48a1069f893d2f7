#!/usr/bin/env python3
"""Smoke run of lc3jax_torch on one CUDA card: build, check, decode,
encode, time.

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero before the
last line). All run at 48 kHz / 10 ms / 150 B, S = 2048 streams, unless
stated. Every serving path (BatchDecoder, BatchEncoder, decode_stream, the
CLI, the sharded steps) runs compiled: one CUDA graph a key, captured at
its first call (lc3jax_torch/compiled.py). Launches are counted in
lc3jax_torch._build.launches, where each kernel wrapper launches; a
replay calls no wrapper, so each graph adds the launches its capture
recorded on every replay, and the launch counts below read the same as
for eager steps. Phase 11 holds those records against the kernels
torch.profiler sees in a replay of every graph:

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: the kernels from lc3jax_torch/csrc, one nvcc per source, all
   at once, then the host packer (native/lc3_bitstream.cc);
3. kernels: each decode kernel against its plain PyTorch version on the
   card: parse on encoded frames mixed with random garbage (all 19 fields
   equal); TNS synthesis (equal) on random lattices, on the decode step's
   arguments for the bench content, and on the shapes of tns_cases: random
   lattices at 48 kHz / 10 ms with S = 2047 (also with x not 16-byte
   aligned) and S = 1, and at 48 kHz / 7.5 ms, 16 kHz / 7.5 ms and
   8 kHz / 10 ms (S = 2048), bandwidths up to
   the config's own and 4 (bounds past ne), orders with ord1 < ord0,
   ord1 > ord0, ord0 = 0 and one filter with ord1 > 0; LTPF (equal) on
   random-state stress inputs at 48 kHz / 10 ms, 48 kHz / 7.5 ms and
   8 kHz / 10 ms (S = 2048), at 48 kHz / 10 ms with S = 2047 and S = 1,
   and on the arguments the decode step gives it for the bench content;
4. enc-kernels: four encoder kernels against their plain versions, on
   random inputs and on the inputs the encoder gives them for the bench
   content (SNS PVQ, TNS coefficients, TNS analysis, bit model: equal,
   every output; the LTPF analysis and the gain estimate are held to theirs
   by the card tests of tests/test_torch_ltpf_enc.py and
   tests/test_torch_gain_estimate.py); the TNS coefficients, lag sums to bits, also on
   tns_coef_cases: S = 2047 and 1, 48 kHz / 7.5 ms, 16 kHz and 8 kHz /
   10 ms, both LPC weightings (nbits on both sides of 480 and 360),
   near_nyquist rows, bandwidths 0-4 (one filter and two), all-zero rows
   (es = 0), tiny rows whose e_prod underflows, prediction gains on both
   sides of 1.5 and 2.0; the TNS analysis also on the
   shapes of tns_cases and with filter bounds beyond LC3's tables, which
   overlap; the SNS PVQ also on pvq_cases: S = 2047 with ties on |x| in
   set B, across the set-A/set-B edge and on every lane, an all-zero set B,
   zeros and -0.0, errors tied between two candidates and every shape, and
   S = 1; the bit model also on bitmodel_cases: rate flags 0 and 512 at
   8 kHz / 10 ms, 16 kHz / 7.5 ms, 48 kHz / 7.5 ms and 48 kHz / 10 ms,
   lastnz = 2 and = ne, ladder depths up to 14, S = 2047 and S = 1); then
   the divisions: each divisor of the encoder's tables (EncoderTables.
   divisors at every rate and frame duration: tools/division_check.py's
   sites) divides a million values on the card as the CPU does, the TNS
   quantiser takes rc = +-0.9829731 to the oracle's rc_i 15 and 1, and
   the bandwidth detector its witness E_B to the oracle's bw_ind 0;
4b. pack-kernels: the bit model with emit_pack against its plain version
   (and its table part against the one without) on the random, bench and
   bitmodel_cases inputs, and the pack kernel
   against its plain version and the C++ host packer, on the fields of four
   batches: the bench content, full-scale noise (48 kHz / 150 B, every
   frame in LSB mode), mixed content at 48 kHz / 10 ms / 400 B and at
   8 kHz / 7.5 ms / 40 B, and the first 2,047 and the first stream of the
   400 B batch; per batch, the frames in LSB mode, with a carry resolved and
   with the finish's extra bit;
4c. parse-kernels: the parse kernel against its plain version on every
   field of the four packed batches (the noise batch's LSB-mode frames
   included: the run fails if none was parsed) and of the first 2,047 and
   the first stream of the 400 B batch;
5. slice: BatchDecoder(cuda).decode over T = 12 frames of the bench content
   (the four signals tiled over the streams, one corrupt frame); PCM within
   1 LSB and >= 100 dB SNR of the stored oracle decode; every decode
   kernel's launch count that of STEP_LAUNCHES["decode"], T frames (every
   launch count in this script reads that table);
6. corpus: the six corpus geometries and stream50 through the decoder at
   S = 1, same bound against the stored oracle PCM;
7. encode: BatchEncoder(cuda).encode over the T frames of the bench
   content; every stream's bytes equal the oracle's; launch counts those of
   STEP_LAUNCHES["fields"];
7b. encode-fused: BatchEncoder(cuda, device_pack=True).encode_tensor over
   the same T frames, PCM to bytes on the card; every stream's bytes equal
   the oracle's; launch counts those of STEP_LAUNCHES["bytes"] (emit_pack
   included);
8. encode-corpus: the six corpus geometries and stream50 through the
   encoder at S = 1, every frame equal to the oracle's bytes;
8b. encode-fused-corpus: the same through BatchEncoder(device_pack=True);
8c. config-parity: the ten config-parity streams, the two 32 kHz attack
   streams and the per-frame rate plan of tests/goldens/torch_config_parity.npz
   (tools/gen_torch_config_parity.py) at S = 1: BatchDecoder within 1 LSB of
   the oracle's PCM, both BatchEncoder modes byte-exact to its frames;
8d. serving: the parse kernel against the C++ host parser
   (coding/host_parse.py) on 2,048 frames at the six corpus geometries and
   8 kHz / 7.5 ms / 30 B, by stream mod 3 encoded, random and encoded with
   3 bytes overwritten (bad_frame equal on every frame, every field on the
   good ones); then on the bench content's T frames (phase 5's corrupt one
   included), each path with the launch counter reset just before it
   and read just after: BatchDecoder(device_parse=False).decode equal to
   phase 5's PCM (parse 0, TNS synthesis T, LTPF T launches);
   decode_stream host-parse sequential and pipelined equal to it, with
   plc_frames as in phase 5, and a source that fails after two batches
   raising in the caller; device-parse decode_stream with fetch=True,
   fetch=False (CUDA tensors) and chunk_frames=5 (5 + 5 + 2) equal to
   phase 5 (parse T); a decoder and an encoder (both modes) checkpointed
   after 6 frames, loaded onto the card into a fresh state, and the next 6
   frames equal to the live run (decoder) or to the oracle's bytes
   (encoder); the CLI on a 4-channel WAV: encode equal to the oracle's
   frames, compare 0, decode within 1 LSB, inspect one line a frame. Then
   times: the host-parse step split into the C++ parse (host wall), the
   copy from the pinned ring and the decode step (CUDA events), and
   decode_stream over 48 batches, host-parse sequential against pipelined
   and device-parse fetch=True against fetch=False and chunk_frames=12,
   alternated rep by rep;
9. times: CUDA events after warm-up, median of 20: the fused decode step
   (decode_tensor, a replayed graph), each kernel, its plain version and the library call where one exists;
   beside each kernel's (and the library call's) per-call event time, its
   device time: the median duration of the kernel itself over 20 calls
   under torch.profiler, without the wrapper's host work. LTPF is timed on
   the stress inputs and on the decode step's own arguments; the TNS
   coefficient kernel alternates call by call with torch.bmm (the lag sums
   alone), median of 200 each; its chain floor: the
   fewest cycles the lag folds and the epilogue of one (stream, filter)
   take alone (the bench's first four streams, S = 1, an instrumented copy
   that also holds the unquantised coefficients equal to tns_lpc_plain), at
   the card's highest SM clock. The TNS synthesis chain floor: the fewest cycles a line one of the
   bench's streams takes alone (S = 1, an instrumented copy of the kernel:
   tools/kernel_phases.py), times the most active lines a stream of the
   decode step runs, at the card's highest SM clock; the SNS PVQ chain floor
   likewise: the fewest cycles a greedy round takes with one of the bench's
   streams alone, times the most rounds a stream of the encoder's bench
   arguments needs. The LTPF analysis also at the benchmark cells'
   settings, S = 2048 (48 kHz / 10 ms / 120 B on the bench content, 16 kHz
   / 10 ms / 40 B on mixed content): event and device times against its
   plain version and its bound, and the device time of one stream alone
   (its chain's time on the card). The gain estimate likewise at the three
   benchmark cells' settings (48 kHz / 10 ms / 120 B on the bench content,
   16 kHz / 10 ms / 40 B and 48 kHz / 7.5 ms / 75 B on mixed content):
   event and device times against its plain version, its byte bound and
   one stream alone on the device (its chain's time on the card). The SNS
   analysis' two kernels (sns_front, sns_finish) likewise at the same three
   settings, and their sum.
   The encode DSP step (a replayed graph; CUDA events, host wall, thread
   CPU time), the
   whole encode with the host pack (host wall, thread CPU time) and the
   fused encode step (CUDA events, host wall) alternate over 20 reps, each
   given as median [min-max]; the C++ host packer alone on the fields of
   the fused step's bench batch, as a comparison (no PyTorch call packs);
10. sharding: lc3jax_torch.parallel on the bench content (the four
   contents cycled, the second half shifted by one) over T frames, at
   meshes ["cuda:0"] and ["cuda:0", "cuda:0"]: the sharded fused decode
   and decode_frames equal to phase 5's PCM, the sharded encode step and
   encode_frames fields equal to the unsharded step's and, packed on the
   host, to the oracle's frames, the sharded fused encode's bytes equal to
   phase 7b's, every gathered state equal to the unsharded one, each path
   with its launches counted per shard; then two processes on the one card
   (this script with --shard-worker and torchrun's environment variables,
   gloo on 127.0.0.1), each its 1,024
   streams through the sharded fused decode and fused encode, the halves
   equal to the one-process outputs (a worker that fails, hangs past 300 s
   or exits non-zero fails the run); then lc3jax_torch.profiling's
   device_step_ms of the fused decode, encode DSP and fused encode steps
   beside tools/torch_profile.py's busy per step, device_loop_span_ms of
   the pipelined host-parse decode_stream over 24 batches beside the same
   loop's host wall with the profiler on and off and phase 8d's host wall,
   and the sharded fused decode step's CUDA-event time at
   both meshes beside decode_tensor, alternated, median of 20;
11. compiled: over the bench content's T frames with the corrupt frame and
   nbytes 150 -> 100 -> 150 -> 100 B inside the run (the 100 B frames from
   the eager fused encode), each compiled path equal to its eager step
   function, every output and the state after every frame (torch.equal):
   the fused decode (decode_tensor), the host-parse decode, decode_stream
   with chunk_frames=2 across the changes and chunk_frames=12 over the
   bench's frames (against eager decode_bytes_frames), make_decode_step /
   make_encode_step (one a frame size, the state handed back and forth),
   the encode DSP step, the fused encode, make_decode_bytes_step (one a
   frame size) and the sharded fused decode at meshes ["cuda:0"] and
   ["cuda:0", "cuda:0"] (one a frame size); each key captured once and
   then only replayed, no state copied on the serving paths, launches
   counted; two streams (shard_tile's streams 0-1023 and 1024-2047, S =
   1024, T frames at 150 B) interleaved through one make_decode_step, one
   make_encode_step, one make_decode_bytes_step and one sharded fused
   decode at mesh ["cuda:0"], each stream equal to its own eager stream,
   state included, after every frame, each step with two static states
   and two graphs (captures, capture ms, pool MiB after each stream's
   first call); per graph (every serving graph, both make_*_step and
   make_decode_bytes_step graphs of each size, every shard's graph), the kernels
   torch.profiler sees in one replay equal to the eager step's launches
   and to the counts its capture recorded (which each replay adds to
   lc3jax_torch._build.launches), its nodes and its capture time; the graphs' pools (torch.cuda.memory_snapshot); then the eager
   step against its replay (fused decode, host-parse decode step, encode
   DSP, fused encode; CUDA events and host wall, alternated, median
   [min-max] of 20) and decode_stream over 48 batches in each device-parse
   mode against the same loop of eager steps (host wall, 5 reps
   alternated);
12. api: lc3jax_torch.api's buffer calculators at 48 kHz / 10 ms (the
   published 27,564 bytes); a two-channel Lc3Encoder / Lc3Decoder over
   stream50 at 120 B, channels called interleaved, launches counted:
   channel 0's bytes equal the oracle's and its PCM within 1 LSB and
   >= 100 dB, channel 1 decodes stream50 with a corrupt, a 10 B and a 0 B
   frame within 1 LSB of the oracle (tests/goldens/torch_api.npz) with
   those three concealed; decode_frame(24, ...) raises ValueError; the
   parse kernel against its plain version at 0, 1, 2 and 3 B, S = 2048 and
   1 (every field equal, every frame bad); a fused decode at S = 2048
   through the 0 B batch (PCM within 1 LSB of the oracle, plc_frames
   3 S); the facade's host wall a frame and channel.

Then the card's line, one JSON line with the kernels (each with its event
and device times and its bound: the larger of its bytes over 3.35 TB/s
and its f32 operations over 67 TFLOP/s, the H100 SXM's published peaks,
counted from this run's inputs; the TNS synthesis and the SNS PVQ also
with their chain floor), and last the device line. Uses no JAX
and nothing of the lc3jax package: the references are the stored goldens
of tests/goldens (tools/gen_torch_encode_goldens.py made the bench
content's).
"""

from __future__ import annotations

import dataclasses
import json
import os
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
PAIR_REPS = 200  # the TNS coefficients against torch.bmm, a few µs apart
STREAM_REPS = 5  # decode_stream runs of 48 batches per mode, alternated
CORPUS = ["48000_10ms_120", "48000_10ms_20", "48000_10ms_400", "44100_7.5ms_100",
          "16000_10ms_60", "8000_10ms_40"]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# f32 operations of one (stream, filter) past the lag folds, counted from
# tns_enc_kernel.tns_coefficients_plain (an asin as one): normalisation 56,
# Levinson-Durbin 160, gate and weighting 34, inverse recursion 100,
# quantisation 24
COEF_EPILOGUE_OPS = 374
F32_FLOP_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores, published
# The kernel inventory: the launches one frame of each step makes, by kernel
# (KERNELS' names), which every launch count below reads through
# step_launches. "decode" is the fused decode (the parse on the card),
# "parsed" the host-parse decode step, "fields" the encode DSP step and
# "bytes" the fused encode, which adds the pack kernel and runs the bit
# model's second launch with emit_pack (EMIT_PACK, counted apart).
STEP_LAUNCHES = {
    "decode": {"parse": 1, "tns_synthesis": 1, "ltpf": 1},
    "parsed": {"tns_synthesis": 1, "ltpf": 1},
    "fields": {"sns_pvq": 1, "tns_coefficients": 1, "tns_analysis": 1, "ltpf_analysis": 1,
               "gain_estimate": 1, "bitmodel_table_part": 2, "sns_front": 1, "sns_finish": 1},
}
STEP_LAUNCHES["bytes"] = dict(STEP_LAUNCHES["fields"], pack=1, emit_pack=1)


def step_launches(*steps: str, n: int = 1) -> dict:
    """The launches of n frames of each of `steps` (a step named twice
    counts twice: two streams, channels or shards), by kernel; "emit_pack"
    only where a fused encode runs, which `counted` and the profiler's
    kernel names do not read."""
    out: dict = {}
    for step in steps:
        for k, v in STEP_LAUNCHES[step].items():
            out[k] = out.get(k, 0) + n * v
    return out


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


def event_ms(fn) -> float:
    """ms between CUDA events recorded around one call of fn."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return float(np.median([event_ms(fn) for _ in range(reps)]))


def cuda_ms_pair(fa, fb, reps: int = REPS) -> tuple[float, float]:
    """cuda_ms of fa and of fb, alternated call by call so that both see
    the same host."""
    import torch

    for _ in range(3):
        fa()
        fb()
    torch.cuda.synchronize()
    ta, tb = [], []
    for _ in range(reps):
        ta.append(event_ms(fa))
        tb.append(event_ms(fb))
    return float(np.median(ta)), float(np.median(tb))


def encode_times(enc, fenc, pcm_host: np.ndarray, pcm_dev, reps: int = REPS) -> dict:
    """The encode DSP step, the whole encode with the host pack and the fused
    encode step (fenc, device_pack=True), alternated rep by rep so that all
    see the same host. Per rep, in ms: the DSP step by CUDA events
    (dsp_event), the host wall until its last launch is queued (dsp_issue)
    and until it is done (dsp_wall), and the issuing thread's CPU time
    (dsp_cpu); then the whole encode's host wall (enc_wall) and the main
    thread's CPU time (enc_cpu; the packer's worker threads not counted);
    then the fused step by CUDA events (fused_event) and host wall
    (fused_wall).
    A host thread that is descheduled shows as wall above CPU time; a slower
    host core as CPU time that moves with the wall. Each rep first times a
    fixed pure-Python loop (probe): it moves with the steps if the host's
    speed is what moves them."""
    import torch

    for _ in range(3):
        enc.encode_fields_tensor(pcm_dev)
        enc.encode(pcm_host)
        fenc.encode_tensor(pcm_dev)
    torch.cuda.synchronize()
    out = {k: [] for k in ("probe", "dsp_event", "dsp_issue", "dsp_wall", "dsp_cpu",
                           "enc_wall", "enc_cpu", "fused_event", "fused_wall")}
    for _ in range(reps):
        t0 = time.perf_counter()
        sum(i * i for i in range(50_000))
        out["probe"].append((time.perf_counter() - t0) * 1e3)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        w0, c0 = time.perf_counter(), time.thread_time()
        a.record()
        enc.encode_fields_tensor(pcm_dev)
        b.record()
        w_issue = time.perf_counter()
        b.synchronize()
        w1, c1 = time.perf_counter(), time.thread_time()
        enc.encode(pcm_host)
        w2, c2 = time.perf_counter(), time.thread_time()
        fa = torch.cuda.Event(enable_timing=True)
        fb = torch.cuda.Event(enable_timing=True)
        fa.record()
        fenc.encode_tensor(pcm_dev)
        fb.record()
        fb.synchronize()
        w3 = time.perf_counter()
        for k, v in (("dsp_event", a.elapsed_time(b)), ("dsp_issue", (w_issue - w0) * 1e3),
                     ("dsp_wall", (w1 - w0) * 1e3), ("dsp_cpu", (c1 - c0) * 1e3),
                     ("enc_wall", (w2 - w1) * 1e3), ("enc_cpu", (c2 - c1) * 1e3),
                     ("fused_event", fa.elapsed_time(fb)), ("fused_wall", (w3 - w2) * 1e3)):
            out[k].append(v)
    return out


def spread(ms) -> str:
    """median [min-max] of a list of ms."""
    return f"{float(np.median(ms)):.4f} [{min(ms):.4f}-{max(ms):.4f}]"


def encode_times_line(et: dict) -> str:
    """The reps of encode_times summarised: each wall or event time as
    median [min-max]; the host part of the whole encode (its wall less the
    same rep's DSP step); each thread's CPU time over its wall, summed over
    the reps (the thread clock may tick coarsely); and how the probe
    correlates with the two steps over the reps."""
    v = {k: np.asarray(x) for k, x in et.items()}
    corr = lambda k: float(np.corrcoef(v["probe"], v[k])[0, 1])
    return "; ".join(
        [f"{k} {spread(v[k])}" for k in ("probe", "dsp_event", "dsp_issue", "dsp_wall",
                                         "enc_wall", "fused_event", "fused_wall")]
        + [f"enc_wall - dsp_wall {spread(v['enc_wall'] - v['dsp_wall'])}",
           f"fused_wall - dsp_wall {spread(v['fused_wall'] - v['dsp_wall'])}",
           f"CPU/wall dsp {v['dsp_cpu'].sum() / v['dsp_wall'].sum():.3f}, "
           f"enc {v['enc_cpu'].sum() / v['enc_wall'].sum():.3f}",
           f"corr(probe, dsp_wall) {corr('dsp_wall'):.2f}, "
           f"corr(probe, enc_wall) {corr('enc_wall'):.2f}, "
           f"corr(probe, fused_wall) {corr('fused_wall'):.2f}"])


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least time in ms, what sets it) on the H100's published peaks."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def device_ms(fn, kernel: str | None, reps: int = REPS) -> float:
    """Median device time in ms of one call of fn under torch.profiler: the
    summed durations of the kernels named `kernel` (every kernel when None)
    that each call launches, the wrapper's host work not included. A
    session that lost launches is taken again (lc3jax_torch.profiling)."""
    import re

    from lc3jax_torch import profiling

    for _ in range(3):
        fn()
    named = re.compile(rf"(?<![A-Za-z_]){kernel}" if kernel else ".")
    pick = lambda spans: [(a, b) for a, b, name in spans if named.search(name)
                          and not name.startswith(("Memcpy", "Memset"))]
    evs = pick(profiling.device_spans(lambda: [fn() for _ in range(reps)],
                                      check=lambda spans: (n := len(pick(spans))) > 0
                                      and n % reps == 0))
    per = len(evs) // reps
    return float(np.median([sum(b - a for a, b in evs[i : i + per])
                            for i in range(0, len(evs), per)])) / 1e3


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


def tns_random(cfg, S: int, seed: int) -> tuple:
    """Random TNS lattice inputs at cfg (numpy): x [S, ne] f32 at scales
    1-1000; bandwidths up to cfg's own, and 4 on every fourth stream (at a
    low rate its bounds run past ne); orders 0-8 with, among them, streams
    where ord1 < ord0, ord1 > ord0, ord0 = 0, and num_filters = 1 with
    ord1 > 0; reflection indices 0-16. Returns x, bw, rc_order,
    num_filters, rc_i."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((S, cfg.ne)) * 10 ** rng.uniform(0, 3, (S, 1))).astype(np.float32)
    k = np.arange(S) % 8
    bw = np.where(k % 4 == 3, 4, rng.integers(0, cfg.fs_ind + 1, S)).astype(np.int32)
    ro = rng.integers(0, 9, (S, 2))
    nf = rng.integers(1, 3, S)
    ro[k == 0], ro[k == 1], ro[k == 2, 0], nf[k < 3] = [7, 3], [2, 8], 0, 2
    ro[k == 4, 1], nf[k == 4] = 6, 1
    return (x, bw, ro.astype(np.int32), nf.astype(np.int32),
            rng.integers(0, 17, (S, 16)).astype(np.int32))


def tns_cases(cfg, dev) -> dict:
    """{label: (synthesis args, analysis args)} on the card: random inputs
    at S = 2047 and S = 1 at cfg (48 kHz / 10 ms), and at S = 2048 at
    48 kHz / 7.5 ms, 16 kHz / 7.5 ms and 8 kHz / 10 ms (tns_random); and
    the S = 2047 inputs with x not 16-byte aligned."""
    import torch

    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.convert import decoder_tables, encoder_tables

    out = {}
    for label, c, S, seed in (("48k/10ms S=2047", cfg, S_MAIN - 1, 20), ("48k/10ms S=1", cfg, 1, 21),
                              ("48k/7.5ms", Lc3Config.new(48000, FrameDuration.MS7P5), S_MAIN, 22),
                              ("16k/7.5ms", Lc3Config.new(16000, FrameDuration.MS7P5), S_MAIN, 23),
                              ("8k/10ms", Lc3Config.new(8000, FrameDuration.MS10), S_MAIN, 24)):
        x, bw, ro, nf, ri = (torch.as_tensor(a, device=dev) for a in tns_random(c, S, seed))
        dt, et = decoder_tables(c, 1200, dev), encoder_tables(c, 1200, dev)
        out[label] = ((dt, x, bw, ro, ri),
                      (x, et.tns_bounds[bw.long()], ro, nf, et.tns_sin[ri.long()]))
    # the same rows 4 bytes past a 16-byte boundary: the kernels' 4-byte staging
    syn, ana = out["48k/10ms S=2047"]
    x = syn[1]
    shifted = x.new_empty(x.numel() + 1)[1:].view(x.shape).copy_(x)
    out["48k/10ms S=2047 x misaligned"] = ((syn[0], shifted, *syn[2:]), (shifted, *ana[1:]))
    return out


def tns_coef_cases(dev) -> dict:
    """{label: tns_coefficients arguments} on the card from
    tools/tns_cases.py's coef_rows: at
    48 kHz / 10 ms with S = 2048, 2047 and 1, nbits 1200 and 400 (LPC
    weighting off and on); 48 kHz / 7.5 ms at 900 and 300 bits; 16 kHz /
    10 ms at 300 and 8 kHz / 10 ms at 600 bits. Fails unless the cases
    reach what coef_rows names (prediction gains on both sides of 1.5 and
    2.0, es = 0, e_prod underflowing, both filters) and no row of them
    gives a NaN reflection coefficient (outside the oracle's domain: its
    int() raises; there are none to leave out)."""
    import torch

    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.convert import encoder_tables
    from lc3jax_torch.dsp import tns_enc_kernel as K
    from tns_cases import coef_rows

    c48 = Lc3Config.new(48000, FrameDuration.MS10)
    out = {}
    for label, c, nb, S, seed in (("48k/10ms 1200b", c48, 1200, S_MAIN, 40),
                                  ("48k/10ms 400b", c48, 400, S_MAIN, 41),
                                  (f"48k/10ms 400b S={S_MAIN - 1}", c48, 400, S_MAIN - 1, 42),
                                  ("48k/10ms 400b S=1", c48, 400, 1, 43),
                                  ("48k/7.5ms 900b", Lc3Config.new(48000, FrameDuration.MS7P5), 900,
                                   S_MAIN, 44),
                                  ("48k/7.5ms 300b", Lc3Config.new(48000, FrameDuration.MS7P5), 300,
                                   S_MAIN, 45),
                                  ("16k/10ms 300b", Lc3Config.new(16000, FrameDuration.MS10), 300,
                                   S_MAIN, 46),
                                  ("8k/10ms 600b", Lc3Config.new(8000, FrameDuration.MS10), 600,
                                   S_MAIN, 47)):
        x, bw, nn = (torch.as_tensor(a, device=dev) for a in coef_rows(c, S, seed))
        lpc = int(nb < (480 if c.n_ms == FrameDuration.MS10 else 360))
        tab = encoder_tables(c, nb, dev)
        out[label] = (tab, x, bw, nn, lpc)
        ac = K.tns_autocorr_plain(x, tab.tns_sub[bw.long()])
        rc, pg = K.tns_lpc_plain(tab, ac, nn, lpc)
        if bool(rc.isnan().any()):
            raise AssertionError(f"tns_coef_cases {label}: a NaN reflection coefficient")
        if S == S_MAIN:
            on = pg[:, 0][~nn]
            es = ac[..., 0]
            reached = [bool(((on > 1.0) & (on < 1.5)).any()), bool(((on > 1.5) & (on < 2.0)).any()),
                       bool((on > 2.0).any()), bool((es == 0).all(2).any()),
                       bool(((es.prod(2) == 0) & (es != 0).all(2)).any()),
                       c.fs_ind < 3 or bool((bw >= 3).any())]
            if not all(reached):
                raise AssertionError(f"tns_coef_cases {label}: cases not reached {reached}")
    return out


def division_phase(card: str, dev) -> str:
    """Each divisor of the encoder's tables (EncoderTables.divisors at every
    rate and frame duration: tools/division_check.py's sites) against the
    CPU's division of the same values by the Python float; the TNS
    quantiser on the witness rc = +-0.9829731 (the oracle's rc_i: 15 and
    1) and the bandwidth detector on its witness E_B (the oracle's bw_ind:
    0), on the card."""
    import torch

    import division_check
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.convert import encoder_tables
    from lc3jax_torch.dsp import tns_enc_kernel
    from lc3jax_torch.dsp.encoder import bandwidth_detect

    rows = division_check.site_rows(dev)
    bad = [label for label, _, n in rows if n]
    if bad:
        raise AssertionError(f"division: the card's division by the tables' divisor differs from "
                             f"the CPU's at {bad}")
    rc = torch.tensor(list(division_check.WITNESS), dtype=torch.float32, device=dev)
    t = encoder_tables(Lc3Config.new(48000, FrameDuration.MS10), 1200, dev)
    got = tns_enc_kernel.tns_quantise_plain(t, rc).tolist()
    if got != list(division_check.WITNESS.values()):
        raise AssertionError(f"division: the TNS quantiser takes the witness to rc_i {got}")
    bw = int(bandwidth_detect(t, torch.as_tensor(division_check.bandwidth_witness(), device=dev))[0][0])
    if bw != division_check.BW_WITNESS_IND:
        raise AssertionError(f"division: the bandwidth detector takes its witness to bw_ind {bw}")
    return (f"{card}: every site divides as the CPU on {division_check.N} values with the tables' "
            f"divisors (with a Python float the card differed at " + ", ".join(
                f"{label} {n}" for label, n, _ in rows) + f"); witness rc_i {got}, witness bw_ind {bw}")


def overlapping_bounds(S: int, ne: int, seed: int) -> np.ndarray:
    """int32 [S, 2, 2] TNS filter bounds beyond LC3's tables, which give
    adjacent filters: filter 1 inside filter 0, filter 0 inside filter 1,
    and random ranges (empty, past ne, in either order), by stream mod 3."""
    rng = np.random.default_rng(seed)
    a = np.sort(rng.integers(0, ne + 20, (S, 4)), axis=1)
    out = rng.integers(0, ne + 20, (S, 2, 2))
    k = np.arange(S) % 3
    out[k == 0] = np.stack([a[:, [0, 3]], a[:, [1, 2]]], 1)[k == 0]
    out[k == 1] = np.stack([a[:, [1, 2]], a[:, [0, 3]]], 1)[k == 1]
    return out.astype(np.int32)


def pvq_cases(dev) -> dict:
    """{label: (t2rot,)} on the card for the SNS PVQ search: S = 2047 rows
    whose ties decide the result (equal |x| in set B, across the set-A/set-B
    edge at lane 10 and on every lane; an all-zero set B; zeros and -0.0; a
    single pulse halfway between two searched gains, so that two candidates'
    errors tie), random rows, and tests/goldens/torch_encode.npz's t2rot,
    which reach every shape; and its first row alone (S = 1)."""
    import torch

    from lc3jax_torch.dsp.sns_kernel import GAINS

    rng = np.random.default_rng(27)
    S = S_MAIN - 1
    r = (rng.standard_normal((S, 16)) * 10 ** rng.uniform(-1, 2, (S, 1))).astype(np.float32)
    sign = lambda shape: np.where(rng.uniform(size=shape) < 0.5, -1, 1).astype(np.float32)
    k = np.arange(S) % 8
    r[k == 0, 10:] = 0.0
    r[k == 1, 10:] = np.float32(1.25) * sign(((k == 1).sum(), 6))
    r[k == 2, 8:12] = 2.5
    r[k == 2, 3] = -2.5
    r[k == 3] = np.round(rng.standard_normal(((k == 3).sum(), 16)) * 3)
    r[k == 4] = np.float32(0.75) * sign(((k == 4).sum(), 16))
    r[k == 5, 12:] = -0.0
    r[k == 5, :4] = 0.0
    pairs = [(GAINS[3, 0], GAINS[3, 1]), (GAINS[3, 2], GAINS[3, 3]), (GAINS[1, 0], GAINS[2, 0]),
             (GAINS[2, 1], GAINS[2, 2])]
    for i in np.flatnonzero(k == 6):
        a, b = pairs[(i // 8) % 4]
        r[i] = 0.0
        r[i, (i // 32) % 16] = np.float32((np.float32(a) + np.float32(b)) / 2) * sign(())
    gold = np.load(ROOT / "tests" / "goldens" / "torch_encode.npz")["sns_t2rot"]
    r[: len(gold)] = gold
    r[~np.abs(r).any(1), 0] = 1.0  # no all-zero row: its projection divides by zero
    t2 = torch.as_tensor(r, device=dev)
    return {f"ties S={S}": (t2,), "S=1": (t2[:1],)}


def bitmodel_cases(dev) -> dict:
    """{label: wrapper arguments} on the card for the bit model: the tuples
    of random spectra at 8 kHz / 10 ms, 16 kHz / 7.5 ms, 48 kHz / 7.5 ms and
    48 kHz / 10 ms (NT = 40, 60, 150, 200) with rate flags 0 and 512, ladder
    depths up to 14, a stream with lastnz = 2 and one with lastnz = ne in the
    same batch, at S = 2047, and that last stream alone (S = 1)."""
    import torch

    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.dsp.encoder import tuple_symbols

    rng = np.random.default_rng(28)
    out = {}
    for fs, dur in ((8000, FrameDuration.MS10), (16000, FrameDuration.MS7P5),
                    (48000, FrameDuration.MS7P5), (48000, FrameDuration.MS10)):
        c = Lc3Config.new(fs, dur)
        S = S_MAIN - 1
        mag = (rng.standard_normal((S, c.ne)) * 3).astype(np.int64)
        xq = np.clip(mag * (1 << rng.integers(0, 15, (S, c.ne))) // 8, -32768, 32767)
        xq[np.arange(c.ne)[None, :] >= rng.integers(2, c.ne + 1, (S, 1))] = 0  # ragged ends
        xq[0, 2:] = 0  # lastnz = 2
        xq[1, -1] = -32768  # lastnz = ne, the deepest ladder (14)
        ts = tuple_symbols(torch.as_tensor(xq.astype(np.int32), device=dev))
        if int(ts["g"].max()) != 14:
            raise AssertionError(f"bitmodel_cases: ladder depths reach {int(ts['g'].max())}, not 14")
        for rf in (0, 512):
            args = (ts["c"], ts["g"], ts["sym"], rf, c.ne, ts["lastnz"])
            out[f"{fs // 1000}k/{dur.name} rf={rf} S={S}"] = args
            out[f"{fs // 1000}k/{dur.name} rf={rf} S=1"] = tuple(a[1:2] if torch.is_tensor(a) else a
                                                                 for a in args)
    return out


def active_lines(tab, bandwidth, rc_order, ne: int):
    """Each stream's active TNS lines (inside a filter of order > 0) [S]."""
    import torch

    b = tab.tns_bounds[bandwidth.long()].long()
    n = torch.arange(ne, device=b.device)[None, :]
    on = [(rc_order[:, f:f + 1] > 0) & (n >= b[:, 2 * f:2 * f + 1]) & (n < b[:, 2 * f + 1:2 * f + 2])
          for f in range(2)]
    return (on[0] | on[1]).sum(1)


def sm_clock_mhz() -> float:
    """The card's highest SM clock, MHz (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0])


def mixed_pcm(cfg, S: int, T: int, seed: int) -> np.ndarray:
    """int16 [T, S, nf] in the pattern of tests/test_pallas_pack.py: silence,
    full-scale noise (LSB mode), tones and quiet noise, by stream mod 4."""
    rng = np.random.default_rng(seed)
    t = np.arange(T * cfg.nf) / cfg.fs
    out = np.zeros((S, T * cfg.nf))  # stream mod 4 == 0: silence
    for i in range(S):
        if i % 4 == 1:
            out[i] = 28000 * rng.standard_normal(T * cfg.nf)
        elif i % 4 == 2:
            out[i] = 15000 * np.sin(2 * np.pi * (220 + 37 * (i % 11)) * t)
        elif i % 4 == 3:
            out[i] = rng.normal(0, 30, T * cfg.nf)
    return np.clip(out, -32768, 32767).astype(np.int16).reshape(S, T, cfg.nf).transpose(1, 0, 2)


def noise_pcm(cfg, S: int, T: int, seed: int) -> np.ndarray:
    """int16 [T, S, nf] full-scale noise, 28,000 rms, clipped."""
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((T, S, cfg.nf)) * 28000, -32768, 32767).astype(np.int16)


def ltpf_tuple(fn):
    """fn (the LTPF analysis or its plain version) returning one tuple: its
    fields, then its state's tensors."""

    def run(*args):
        fields, st = fn(*args)
        return (*fields.values(), *(getattr(st, f.name) for f in dataclasses.fields(st)))

    return run


def ltpf_first_stream(args) -> tuple:
    """ltpf_analysis arguments cut to their first stream."""
    from lc3jax_torch.dsp.encoder_ltpf import LtpfEncState

    cfg, tab, st, x, nn, nbits = args
    one = LtpfEncState(**{f.name: getattr(st, f.name)[:1] for f in dataclasses.fields(st)})
    return cfg, tab, one, x[:1], nn[:1], nbits


def ltpf_analysis_bound(args) -> tuple[float, str]:
    """The LTPF analysis' bound on these arguments: the bytes it reads (the
    part of each history it keeps: x_ext's last num samples, x12 past its
    first len12, x64 past its first len64; the frame, the memories, its
    tables) and writes (the new state, four fields), and its multiplies and
    adds (resampler, biquad, downsample, lag folds, energies, refinement,
    interpolation, activation)."""
    from lc3jax_torch.dsp import encoder_ltpf, ltpf_enc_kernel

    cfg, _, st, x, nn, _ = args
    k = ltpf_enc_kernel.kernel_consts(cfg, x.device)
    reads = nbytes_of(st.x_ext[:, -k.num:], st.x12[:, k.len12:], st.x64[:, k.len64:], x, nn,
                      st.h50_m1, st.h50_m2, st.t_prev, st.mem_pitch, st.mem_active, st.mem_nc,
                      st.mem_mem_nc, k.resamp_idx, k.resamp_tap, k.lag_weight, k.interp_r,
                      k.h_taps)
    writes = nbytes_of(*ltpf_tuple(encoder_ltpf.ltpf_analysis_plain)(*args))
    ops = (2 * k.len12 * k.ntaps + 8 * k.len12 + 9 * k.len64 + (2 * k.len64 + 1) * encoder_ltpf.NLAGS
           + 6 * k.len64 + 2 * 17 * k.len12 + 7 * 16 + 24 * k.len12)
    return bound(reads + writes, float(x.shape[0] * ops))


def gain_bound(args) -> tuple[float, str]:
    """The gain estimate's bound on these arguments: it reads the energies,
    the bit budgets and the divisor and writes the index; a stream scales
    each energy twice (2 divisions, 3 multiplies) and runs 8 folds of 6 adds
    a term."""
    e, adj, _, d = args
    S, n4 = e.shape
    return bound(nbytes_of(e, adj, d) + nbytes_of(adj), float(S * n4 * (5 + 8 * 6)))


# f32 operations a stream of the SNS analysis' kernels, counted from
# encoder.sns_front_plain and sns_finish_plain (a log2 or an exp2f as one):
# front: smoothing and pre-emphasis 6 a band, the total 1, floor, log2 and
# halving 4, the grouping 12 a group, two means and their removal 3 a
# group, the attack windows 6, the codebook rows 24 each of 64, the
# residual 1 and the rotation 32 a scale factor; finish: the synthesis 34
# a scale factor, the interpolation 3 a point, the enumerations 8 a
# position, then 1 a line (the shaping)
SNS_OPS = {"sns_front": 64 * 6 + 64 + 64 * 4 + 16 * 12 + 16 * 3 * 2 + 16 * 6 + 64 * 24
           + 16 + 16 * 32,
           "sns_finish": 16 * 34 + 64 * 3 + 2 * 16 * 8}


def sns_finish_tuple(fn):
    """fn (sns_finish or its plain version) returning one tuple: the shaped
    spectrum, then the seven fields."""

    def run(*args):
        x_s, fields = fn(*args)
        return (x_s, *fields.values())

    return run


def sns_bound(name: str, args, plain) -> tuple[float, str]:
    """An SNS analysis kernel's bound on these arguments: the tensors it
    reads (the spectrum's first ne lines a row) and writes, and SNS_OPS a
    stream plus a multiply a line."""
    import torch

    reads = [t for t in args if torch.is_tensor(t)]
    tab = args[0]
    tables = ([tab.preemph, tab.group_idx, tab.group_w, tab.lfcb, tab.hfcb, tab.dct16]
              if name == "sns_front" else [tab.dct16, tab.mpvq_offsets, tab.band_of_line])
    S = reads[0].shape[0]
    lines = tab.p.cfg.ne if name == "sns_finish" else 0
    return bound(nbytes_of(*reads, *tables, *plain(*args)), float(S * (SNS_OPS[name] + lines)))


def capture_kernel_inputs(cfg, pcm, nbytes: int = NBYTES):
    """Run one eager encode step from a fresh state and keep the arguments
    each encoder kernel gets (the serving steps run captured graphs, whose
    kernels' arguments live in the graph's pool)."""
    from lc3jax_torch.dsp import bitmodel_kernel, encoder, sns_kernel, tns_enc_kernel
    from lc3jax_torch.dsp.encoder import encode_step, encoder_init

    seen = {}
    spies = [(sns_kernel, "sns_pvq"), (tns_enc_kernel, "tns_coefficients"),
             (tns_enc_kernel, "tns_analysis"), (encoder, "ltpf_analysis"),
             (encoder, "gain_estimate"), (bitmodel_kernel, "bitmodel_table_part"),
             (encoder, "sns_front"), (encoder, "sns_finish")]
    originals = [getattr(m, n) for m, n in spies]
    for (m, n), orig in zip(spies, originals):
        def spy(*a, _n=n, _orig=orig, **kw):
            seen.setdefault(_n, a)
            return _orig(*a, **kw)
        setattr(m, n, spy)
    try:
        encode_step(cfg, nbytes, encoder_init(cfg, pcm.shape[0], pcm.device), pcm)
    finally:
        for (m, n), orig in zip(spies, originals):
            setattr(m, n, orig)
    return seen


def capture_ltpf_inputs(cfg, frames):
    """Decode the frames with the eager fused step and keep the arguments
    the last decode step gave the LTPF kernel."""
    import torch

    from lc3jax_torch.coding.device import decode_bytes_step
    from lc3jax_torch.dsp import ltpf_kernel
    from lc3jax_torch.dsp.decoder import decoder_init

    seen = {}
    orig = ltpf_kernel.ltpf_both_passes

    def spy(*a, **kw):
        seen["ltpf"] = a
        return orig(*a, **kw)

    ltpf_kernel.ltpf_both_passes = spy
    try:
        st = decoder_init(cfg, frames[0].shape[0], "cuda")
        for f in frames:
            st, _ = decode_bytes_step(cfg, NBYTES, st, torch.as_tensor(f, device="cuda"))
    finally:
        ltpf_kernel.ltpf_both_passes = orig
    return seen["ltpf"]


def parse_equal(label: str, cfg, nbytes: int, payloads):
    """The parse kernel against its plain version, every field equal;
    returns the plain version's fields."""
    import torch

    from lc3jax_torch.coding import device as cdev
    from lc3jax_torch.coding import parse_kernel

    got = parse_kernel.parse_frames_cuda(cfg, nbytes, payloads)
    want = cdev.device_parse_plain(cfg, nbytes, payloads)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            bad = (a != b).reshape(a.shape[0], -1).any(1).nonzero().flatten()[:8].tolist()
            raise AssertionError(f"parse ({label}): kernel != plain on field {f.name}, "
                                 f"streams {bad}")
    return want


def equal_outputs(name: str, a, b) -> None:
    import torch

    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for i, (x, y) in enumerate(zip(a, b)):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            bad = (x != y).reshape(x.shape[0], -1).any(1).nonzero().flatten()[:8].tolist()
            raise AssertionError(f"{name} kernel != plain (output {i}), streams {bad}")


# the kernels: name -> (C entry, which lc3jax_torch._build.launches
# counts by; the __global__ function, as torch.profiler names it; the
# source under lc3jax_torch/csrc/; the TPU kernel it replaces)
KERNELS = {
    "parse": ("lc3t_parse", "parse_kernel", "parse.cu", "lc3jax/coding/pallas_parse.py:597"),
    "tns_synthesis": ("lc3t_tns_synthesis", "tns_synthesis_kernel", "tns_synthesis.cu",
                      "lc3jax/dsp/pallas_tns.py:226"),
    "ltpf": ("lc3t_ltpf_both_passes", "ltpf_kernel", "ltpf.cu",
             "lc3jax/dsp/pallas_ltpf.py:122"),
    "sns_pvq": ("lc3t_sns_pvq", "sns_pvq_kernel", "sns_pvq.cu", "lc3jax/dsp/pallas_sns.py:199"),
    "tns_coefficients": ("lc3t_tns_coefficients", "tns_coefficients_kernel", "tns_coefficients.cu",
                         "lc3jax/dsp/pallas_tns.py:158"),
    "tns_analysis": ("lc3t_tns_analysis", "tns_analysis_kernel", "tns_analysis.cu",
                     "lc3jax/dsp/pallas_tns.py:190"),
    "bitmodel_table_part": ("lc3t_bitmodel", "bitmodel_kernel", "bitmodel.cu",
                            "lc3jax/dsp/pallas_bitmodel.py:235"),
    "pack": ("lc3t_pack", "pack_kernel", "pack.cu", "lc3jax/coding/pallas_pack.py:574"),
    "ltpf_analysis": ("lc3t_ltpf_analysis", "ltpf_analysis_kernel", "ltpf_analysis.cu",
                      "no pallas_call: XLA glue in lc3jax (lc3jax/dsp/encoder_ltpf.py)"),
    "gain_estimate": ("lc3t_gain_estimate", "gain_estimate_kernel", "gain_estimate.cu",
                      "no pallas_call: XLA glue in lc3jax (lc3jax/dsp/encoder.py)"),
    "sns_front": ("lc3t_sns_front", "sns_front_kernel", "sns_analysis.cu",
                  "no pallas_call: XLA glue in lc3jax (lc3jax/dsp/encoder.py:sns_analysis)"),
    "sns_finish": ("lc3t_sns_finish", "sns_finish_kernel", "sns_analysis.cu",
                   "no pallas_call: XLA glue in lc3jax (lc3jax/dsp/encoder.py:sns_analysis)"),
}
EMIT_PACK = "lc3t_bitmodel:emit_pack"  # the bit model's launches with emit_pack


def launch_counts(counts=None) -> dict:
    """Each kernel's launches in `counts` (default: lc3jax_torch._build.launches,
    the port's one launch counter, by C entry), by the kernel's name."""
    from lc3jax_torch import _build

    counts = _build.launches if counts is None else counts
    return {k: counts[entry] for k, (entry, *_) in KERNELS.items()}


def counted(label: str, expect: dict, fn):
    """Run fn with the launch counter reset just before and read just
    after; fail unless each kernel launched as often as `expect` says (0
    where it does not name it). Returns (fn's result, the counts)."""
    from lc3jax_torch import _build

    _build.launches.clear()
    out = fn()
    got = launch_counts()
    want = {k: expect.get(k, 0) for k in KERNELS}
    if got != want:
        raise AssertionError(f"{label}: launch counts {got} != {want}")
    return out, {k: v for k, v in got.items() if v}


def fuzz_batch(enc: np.ndarray, S: int, seed: int) -> np.ndarray:
    """uint8 [S, nbytes] by stream mod 3: the encoded frames cycled, random
    bytes, and the encoded frames with 3 random bytes each overwritten."""
    rng = np.random.default_rng(seed)
    nb = enc.shape[1]
    out = enc[np.arange(S) % len(enc)].copy()
    k = np.arange(S) % 3
    out[k == 1] = rng.integers(0, 256, ((k == 1).sum(), nb), dtype=np.uint8)
    for i in np.flatnonzero(k == 2):
        out[i, rng.integers(0, nb, 3)] = rng.integers(0, 256, 3)
    return out


def serving_phase(card: str, cfg, bench, corpus, cp, pcm5: np.ndarray) -> dict:
    """Phase 8d: the parser fuzz on the card, then the host-parse decode,
    decode_stream in each mode, checkpoints and the CLI at S = 2048 on the
    bench content (phase 5's frames, the corrupt one included), each path
    with its launch counts; then their times. Returns decode_stream's x
    realtime per mode, median over the reps."""
    import contextlib
    import io
    import tempfile
    import threading

    import torch

    from lc3jax_torch.checkpoint import load_state, save_state
    from lc3jax_torch.coding import parse_kernel
    from lc3jax_torch.coding.host_parse import HostParser
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.dsp.decoder import decode_step, decoder_init
    from lc3jax_torch.dsp.encoder import encoder_init
    from lc3jax_torch.runner import cli
    from lc3jax_torch.runner.wav import read_wav, write_wav
    from lc3jax_torch.serving import BatchDecoder, BatchEncoder

    dev = torch.device("cuda")
    S, T = S_MAIN, T_FRAMES
    tile = np.arange(S) % 4
    frames = bench["frames"]  # [4, T, nbytes], frame 5 of content 2 corrupt
    want = bench["pcm_out"][:, :T]
    encoded = bench["encoded"][:, :T]
    batches = [np.ascontiguousarray(frames[tile, f]) for f in range(T)]
    dec_counts = step_launches("parsed", n=T)
    fused_counts = step_launches("decode", n=T)
    stacked = lambda outs: np.stack(outs, 1)  # T x [S, nf] -> [S, T, nf]

    # ---- the parse kernel against the C++ host parser: encoded frames mixed
    # with random bytes and with overwritten bytes, the six corpus geometries
    # and 8 kHz / 7.5 ms / 30 B (the comparison's launches are not counted)
    lines = []
    sources = [(k, corpus[k + "_payloads"]) for k in CORPUS]
    sources.append(("8000_7.5ms_30", cp["8000_7.5ms_30_payloads"]))
    for i, (key, enc) in enumerate(sources):
        fs, ms, nb = key.split("_")
        c = Lc3Config.new(int(fs), FrameDuration.MS7P5 if ms == "7.5ms" else FrameDuration.MS10)
        pl = fuzz_batch(enc, S, seed=40 + i)
        host = HostParser(c).parse(pl)
        got = parse_kernel.parse_frames_cuda(c, int(nb), torch.as_tensor(pl, device=dev))
        bad = host["bad_frame"]
        if not np.array_equal(got.bad_frame.cpu().numpy(), bad):
            raise AssertionError(f"fuzz {key}: bad_frame differs between the kernel and the "
                                 "C++ parser")
        for name, a in host.items():
            b = getattr(got, name).cpu().numpy()
            if b.dtype != a.dtype or not np.array_equal(b[~bad], a[~bad]):
                rows = np.flatnonzero((b != a).reshape(S, -1).any(1) & ~bad)[:8].tolist()
                raise AssertionError(f"fuzz {key}: field {name} differs on good frames {rows}")
        # the untouched encoded rows are bad only where the encoded frame is
        # (the 20 B corpus has one the reference parsers reject too)
        own = HostParser(c).parse(enc)["bad_frame"][np.arange(0, S, 3) % len(enc)]
        if not np.array_equal(bad[0::3], own) or bad.all() or not bad.any():
            raise AssertionError(f"fuzz {key}: unexpected bad-frame pattern ({int(bad.sum())} bad)")
        lines.append(f"{key}: {int(bad.sum())}/{S} bad")
    log("serving", "parse kernel = C++ host parser on every field of the good frames and on "
                   "bad_frame: " + "; ".join(lines))

    # ---- host-parse decode
    hp = BatchDecoder(cfg, S, NBYTES, device="cuda", device_parse=False)
    host_pcm, n = counted("host-parse decode", dec_counts,
                          lambda: stacked([hp.decode(b) for b in batches]))
    if not np.array_equal(host_pcm, pcm5):
        raise AssertionError("host-parse decode != phase 5's fused decode")
    if hp.metrics.plc_frames != S // 4:
        raise AssertionError(f"host-parse plc_frames {hp.metrics.plc_frames} != {S // 4}")
    lines = [f"host-parse decode = fused decode, launches {n}, "
             + check_envelope("contents 0-3", host_pcm[:4], want)]

    # ---- decode_stream, host parse: sequential and pipelined
    outs = {}
    for pipe in (False, True):
        d = BatchDecoder(cfg, S, NBYTES, device="cuda", device_parse=False)
        got, n = counted(f"decode_stream host-parse pipeline={pipe}", dec_counts,
                         lambda: d.decode_stream(iter(batches), pipeline=pipe))
        if not np.array_equal(stacked(got), host_pcm) or d.metrics.plc_frames != S // 4:
            raise AssertionError(f"decode_stream host-parse pipeline={pipe}: PCM or plc_frames "
                                 f"({d.metrics.plc_frames}) differ")
        outs[pipe] = n
    lines.append(f"decode_stream host-parse sequential = pipelined = decode, launches "
                 f"{outs[True]}, plc_frames {S // 4}")

    def failing():
        yield batches[0]
        yield batches[1]
        raise RuntimeError("the source failed after two batches")

    caught = []

    def run_failing():
        try:
            BatchDecoder(cfg, S, NBYTES, device="cuda", device_parse=False).decode_stream(
                failing(), pipeline=True)
        except RuntimeError as e:
            caught.append(e)

    th = threading.Thread(target=run_failing, daemon=True)
    th.start()
    th.join(120)
    if th.is_alive() or not caught or "after two batches" not in str(caught[0]):
        raise AssertionError(f"decode_stream pipelined: a failing source gave {caught} "
                             f"(thread alive: {th.is_alive()})")
    lines.append("a source failing after two batches raises in the caller")

    # ---- decode_stream, device parse: fetch=True, fetch=False, chunk_frames=5
    d = BatchDecoder(cfg, S, NBYTES, device="cuda")
    got, n = counted("decode_stream fetch=True", fused_counts,
                     lambda: d.decode_stream(iter(batches)))
    if not np.array_equal(stacked(got), pcm5) or d.metrics.plc_frames != S // 4:
        raise AssertionError(f"decode_stream fetch=True: PCM or plc_frames "
                             f"({d.metrics.plc_frames}) differ from phase 5")
    d = BatchDecoder(cfg, S, NBYTES, device="cuda")
    got, _ = counted("decode_stream fetch=False", fused_counts,
                     lambda: d.decode_stream(iter(batches), fetch=False))
    if not all(t.is_cuda for t in got) or not np.array_equal(
            stacked([t.cpu().numpy() for t in got]), pcm5):
        raise AssertionError("decode_stream fetch=False: not CUDA tensors equal to phase 5")
    d = BatchDecoder(cfg, S, NBYTES, device="cuda")
    got, _ = counted("decode_stream chunk_frames=5", fused_counts,
                     lambda: d.decode_stream(iter(batches), chunk_frames=5))
    # the chunk graph (key ("chunk", nbytes, T)) replayed twice, the last 2 batches alone
    calls = {k: (s.captures, s.calls) for k, s in d.steps.items()}
    if calls != {("chunk", NBYTES, 5): (1, 2), ("stats", NBYTES, 0): (1, 2)} or not np.array_equal(
            stacked(got), pcm5):
        raise AssertionError(f"decode_stream chunk_frames=5: steps (captures, calls) {calls}, "
                             "or PCM differs")
    lines.append(f"decode_stream device-parse fetch=True (plc_frames {S // 4}), fetch=False "
                 f"(CUDA tensors) and chunk_frames=5 (chunks 5 + 5, then 2 batches alone) = "
                 f"phase 5, launches {n} each")

    # ---- checkpoints: 6 frames, save, load onto the card, the next 6
    scratch = ROOT / "build"
    scratch.mkdir(parents=True, exist_ok=True)
    tag = f"48000/MS10/S={S}/nbytes={NBYTES}"
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = str(Path(tmp) / "decoder.npz")
        d = BatchDecoder(cfg, S, NBYTES, device="cuda")
        for b in batches[:6]:
            d.decode(b)
        save_state(path, d.state, config_tag=tag)
        r = BatchDecoder(cfg, S, NBYTES, device="cuda")
        r.state = load_state(path, decoder_init(cfg, S, "cuda"), config_tag=tag)
        if not (r.state.mem_ola.is_cuda and r.state.ltpf.hist_y.is_cuda):
            raise AssertionError("checkpoint: the decoder state did not load onto the card")
        if not np.array_equal(stacked([r.decode(b) for b in batches[6:]]), pcm5[:, 6:]):
            raise AssertionError("checkpoint: the resumed decoder differs from the live run")
        for fused in (False, True):
            pcm_b = [np.ascontiguousarray(bench["pcm_in"][tile, f]) for f in range(T)]
            e = BatchEncoder(cfg, S, NBYTES, device="cuda", device_pack=fused)
            first = [e.encode(x) for x in pcm_b[:6]]
            path = str(Path(tmp) / f"encoder_{fused}.npz")
            save_state(path, e.state, config_tag=tag)
            r = BatchEncoder(cfg, S, NBYTES, device="cuda", device_pack=fused)
            r.state = load_state(path, encoder_init(cfg, S, "cuda"), config_tag=tag)
            got = stacked(first + [r.encode(x) for x in pcm_b[6:]])
            if not np.array_equal(got, encoded[tile]):
                bad = np.flatnonzero((got != encoded[tile]).any(2).any(0)).tolist()
                raise AssertionError(f"checkpoint: encoder (device_pack={fused}) frames {bad} "
                                     "differ from the oracle's")
    lines.append("checkpoints: the decoder resumed on the card = the live run; the encoder "
                 "resumed in both modes, every frame byte-exact to the oracle's")

    # ---- the CLI on a 4-channel WAV of the bench content's 12 frames
    nf = cfg.nf
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        f = {k: str(Path(tmp) / k) for k in ("in.wav", "out.lc3", "oracle.lc3", "frames.lc3",
                                              "out.wav", "mono.lc3")}
        write_wav(f["in.wav"], bench["pcm_in"][:, :T].transpose(1, 2, 0).reshape(T * nf, 4),
                  cfg.fs)
        Path(f["oracle.lc3"]).write_bytes(encoded.transpose(1, 0, 2).tobytes())
        Path(f["frames.lc3"]).write_bytes(frames[:, :T].transpose(1, 0, 2).tobytes())
        Path(f["mono.lc3"]).write_bytes(frames[2, :T].tobytes())
        enc_counts = step_launches("fields", n=T)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc, n_enc = counted("cli encode", enc_counts, lambda: cli.main(
                ["encode", f["in.wav"], f["out.lc3"], "--nbytes", str(NBYTES)]))
            if rc != 0 or Path(f["out.lc3"]).read_bytes() != Path(f["oracle.lc3"]).read_bytes():
                raise AssertionError("cli encode: the file differs from the oracle's frames")
            if cli.main(["compare", f["out.lc3"], f["oracle.lc3"]]) != 0:
                raise AssertionError("cli compare: not identical")
            rc, n_dec = counted("cli decode", dec_counts, lambda: cli.main(
                ["decode", f["frames.lc3"], f["out.wav"], "--rate", str(cfg.fs), "--channels",
                 "4", "--nbytes", str(NBYTES)]))
            mark = text.tell()
            cli.main(["inspect", f["mono.lc3"], "--nbytes", str(NBYTES)])
        inspected = text.getvalue()[mark:].splitlines()
        out, rate = read_wav(f["out.wav"])
        if rc != 0 or rate != cfg.fs or out.shape != (T * nf, 4):
            raise AssertionError(f"cli decode: rc {rc}, {rate} Hz, shape {out.shape}")
        env = check_envelope("cli decode", out.reshape(T, nf, 4).transpose(2, 0, 1), want)
        if len(inspected) != T or not all(l.startswith(f"frame {i}: ")
                                          for i, l in enumerate(inspected)):
            raise AssertionError(f"cli inspect: {inspected}")
    lines.append(f"cli: encode = the oracle's frames (launches {n_enc}), compare 0, {env} "
                 f"(launches {n_dec}), inspect {len(inspected)} lines "
                 f"({sum('CORRUPT' in l for l in inspected)} CORRUPT)")
    log("serving", "; ".join(lines))

    # ---- times: the host-parse step split; decode_stream modes over 48 batches
    parser = HostParser(cfg, dev)
    st = decoder_init(cfg, S, "cuda")
    split = {k: [] for k in ("parse_wall", "copy_event", "decode_event", "step_wall")}
    for r in range(3 + REPS):
        b = batches[r % T]
        ea, eb, ec = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        w0 = time.perf_counter()
        parser.parse(b)
        w1 = time.perf_counter()
        ea.record()
        fr = parser.upload()
        eb.record()
        st, pcm = decode_step(cfg, NBYTES * 8, st, fr)
        ec.record()
        ec.synchronize()
        w2 = time.perf_counter()
        if r >= 3:  # after warm-up
            for k, v in (("parse_wall", (w1 - w0) * 1e3), ("copy_event", ea.elapsed_time(eb)),
                         ("decode_event", eb.elapsed_time(ec)), ("step_wall", (w2 - w0) * 1e3)):
                split[k].append(v)
    many = [batches[f % T] for f in range(4 * T)]
    audio = len(many) * S * cfg.nf / cfg.fs

    def stream_times(modes: dict, reps: int = STREAM_REPS) -> dict:
        """Host wall of decode_stream over the 48 batches per mode, the modes
        alternated rep by rep after one warm-up each: ms and x realtime."""
        decs = {k: BatchDecoder(cfg, S, NBYTES, device="cuda", device_parse=dp)
                for k, (dp, _) in modes.items()}
        walls = {k: [] for k in modes}
        for r in range(reps + 1):
            for k, (_, kw) in modes.items():
                torch.cuda.synchronize()
                w0 = time.perf_counter()
                decs[k].decode_stream(iter(many), **kw)
                if r:
                    walls[k].append((time.perf_counter() - w0) * 1e3)
        return walls

    host_modes = stream_times({"sequential": (False, {}),
                               "pipelined": (False, {"pipeline": True})})
    dev_modes = stream_times({"fetch=True": (True, {}), "fetch=False": (True, {"fetch": False}),
                              "chunk_frames=12": (True, {"chunk_frames": 12})})
    rt = lambda ms: audio / (np.asarray(ms) / 1e3)
    log("serving-times", f"{card}, S={S}, 48k/10ms/150B, median [min-max]: host-parse step "
        f"({REPS} reps) " + ", ".join(f"{k} {spread(v)} ms" for k, v in split.items())
        + f"; decode_stream over {len(many)} batches, {STREAM_REPS} reps alternated: " + "; ".join(
            f"{k} {spread(v)} ms = {spread(list(rt(v)))} x realtime"
            for k, v in {**host_modes, **dev_modes}.items()))
    return {k: float(np.median(rt(v))) for k, v in {**host_modes, **dev_modes}.items()}


def same(label: str, a, b) -> None:
    """Two trees equal leaf by leaf (torch.equal, dtype and shape included;
    == for scalars)."""
    import torch

    from lc3jax_torch.compiled import leaves

    la, lb = leaves(a), leaves(b)
    bad = [i for i, (x, y) in enumerate(zip(la, lb)) if not (
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        if torch.is_tensor(x) else x == y)]
    if len(la) != len(lb) or bad:
        raise AssertionError(f"{label}: {len(bad)} of {len(la)} leaves differ "
                             f"(first {bad[:4]})")


def shard_tile(S: int) -> np.ndarray:
    """Content index of each stream for phase 10: the four bench contents
    cycled, the second half shifted by one, so that the two halves (and the
    two processes) hold different streams."""
    s = np.arange(S)
    return (s + s // (S // 2)) % 4


def shard_worker(out: str) -> int:
    """One of phase 10's two processes on the one card, started with
    torchrun's environment (MASTER_ADDR/PORT, WORLD_SIZE, RANK, LOCAL_RANK
    = 0): its half of the streams through the sharded fused decode and the
    sharded fused encode, T frames each, the PCM, bytes and launch counts
    written to `out`."""
    import torch

    sys.path.insert(0, str(ROOT))
    from lc3jax_torch import parallel
    from lc3jax_torch.config import FrameDuration, Lc3Config

    rank = int(os.environ["RANK"])
    parallel.init_multihost(backend="gloo")  # NCCL refuses two ranks on one card
    mesh = parallel.multihost_stream_mesh()
    if (mesh.rank, mesh.world, mesh.devices) != (rank, 2, (torch.device("cuda", 0),)):
        raise AssertionError(f"rank {rank}: mesh {mesh}")
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    bench = np.load(ROOT / "tests" / "goldens" / "torch_bench_content.npz")
    n = S_MAIN // mesh.world
    tile = shard_tile(S_MAIN)[rank * n : (rank + 1) * n]
    dec_step = parallel.make_sharded_decode_bytes_step(cfg, NBYTES, mesh)
    enc_step = parallel.make_sharded_encode_bytes_step(cfg, NBYTES, mesh)
    local = lambda a: parallel.multihost_shard_streams(mesh, np.ascontiguousarray(a))

    def run():
        st_d = parallel.sharded_decoder_init(cfg, n, mesh)
        st_e = parallel.sharded_encoder_init(cfg, n, mesh)
        pcm, frames = [], []
        for f in range(T_FRAMES):
            st_d, p = dec_step(st_d, local(bench["frames"][tile, f]))
            st_e, b = enc_step(st_e, local(bench["pcm_in"][tile, f]))
            pcm.append(p.gather().numpy())
            frames.append(b.gather().numpy())
        return np.stack(pcm, 1), np.stack(frames, 1)

    T = T_FRAMES
    (pcm, frames), counts = counted(f"rank {rank}", step_launches("decode", "bytes", n=T), run)
    np.savez(out, pcm=pcm, frames=frames, counts=json.dumps(counts))
    torch.distributed.destroy_process_group()
    return 0


def two_processes(timeout: float = 300.0) -> list:
    """Phase 10's two processes joined by gloo on 127.0.0.1, on the one
    card; fails if either fails, hangs past `timeout` or exits non-zero.
    Returns each rank's outputs."""
    import socket
    import tempfile

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    scratch = ROOT / "build"
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        outs = [str(Path(tmp) / f"rank{r}.npz") for r in range(2)]
        logs = [Path(tmp) / f"rank{r}.log" for r in range(2)]
        env = lambda r: dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                             WORLD_SIZE="2", RANK=str(r), LOCAL_RANK="0")
        procs = []
        deadline = time.monotonic() + timeout
        try:
            for r in range(2):
                with open(logs[r], "w") as log_file:  # the child holds its own copy
                    procs.append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()), "--shard-worker", outs[r]],
                        cwd=ROOT, env=env(r), stdout=log_file, stderr=subprocess.STDOUT))
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:  # a rank whose peer died waits in the rendezvous
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError("two processes: exit codes "
                                 f"{[p.returncode for p in procs]}\n" + "\n".join(
                                     log.read_text()[-3000:] for log in logs))
        return [dict(np.load(o)) for o in outs]


def sharding_phase(card: str, cfg, bench, pcm5: np.ndarray, fused5: np.ndarray,
                   stream_rt: dict) -> None:
    """Phase 10: lc3jax_torch.parallel on meshes ["cuda:0"] and ["cuda:0",
    "cuda:0"] and in two processes, each path held equal to the unsharded
    one and the oracle's bytes with its launches counted; then
    lc3jax_torch.profiling beside tools/torch_profile.py, and the sharded
    decode step's time beside decode_tensor."""
    import torch

    import torch_profile
    from lc3jax_torch import parallel, profiling
    from lc3jax_torch.coding import host_pack
    from lc3jax_torch.coding.device import decode_bytes_step, device_parse, encode_bytes_step
    from lc3jax_torch.convert import encoder_fields_to_numpy
    from lc3jax_torch.dsp.decoder import ParsedFrames, decoder_init
    from lc3jax_torch.dsp.encoder import encode_step, encoder_init
    from lc3jax_torch.serving import BatchDecoder, BatchEncoder

    dev = torch.device("cuda", 0)
    S, T = S_MAIN, T_FRAMES
    tile = shard_tile(S)
    t0 = time.perf_counter()
    took = lambda: f"({time.perf_counter() - t0:.1f} s into the phase)"
    # phase 5 showed every stream of a content decoding alike, and phase 7b
    # every stream of a content encoding to the oracle's frames: so rows 0-3
    # of their outputs are the four contents
    want_pcm, want_fused = pcm5[tile], fused5[tile]  # [S, T, ...]
    encoded = bench["encoded"][tile, :T]
    pay_np = [np.ascontiguousarray(bench["frames"][tile, f]) for f in range(T)]
    pay = [torch.as_tensor(p, device=dev) for p in pay_np]
    pcm_in = torch.as_tensor(np.ascontiguousarray(bench["pcm_in"][tile, :T].transpose(1, 0, 2)),
                             device=dev)  # [T, S, nf]

    def packed_equal(label: str, fields: dict, f: int) -> None:
        got = host_pack.pack_frames(cfg, encoder_fields_to_numpy(fields), NBYTES)
        bad = np.flatnonzero((got != encoded[:, f]).any(1))
        if bad.size:
            raise AssertionError(f"{label}: frame {f} of streams {bad[:8].tolist()} differs "
                                 "from the oracle's")

    # ---- the unsharded references
    st_d = decoder_init(cfg, S, dev)
    ref_pcm = []
    for f in range(T):
        st_d, p = decode_bytes_step(cfg, NBYTES, st_d, pay[f])
        ref_pcm.append(p)
    ref_pcm = torch.stack(ref_pcm, 1)
    if not np.array_equal(ref_pcm.cpu().numpy(), want_pcm):
        raise AssertionError("sharding: the unsharded decode differs from phase 5's")
    st_e, ref_fields = encoder_init(cfg, S, dev), []
    for f in range(T):
        st_e, fields = encode_step(cfg, NBYTES, st_e, pcm_in[f])
        ref_fields.append(fields)
    st_f, ref_bytes = encoder_init(cfg, S, dev), []
    for f in range(T):
        st_f, b = encode_bytes_step(cfg, NBYTES, st_f, pcm_in[f])
        ref_bytes.append(b)
    if not np.array_equal(torch.stack(ref_bytes, 1).cpu().numpy(), want_fused):
        raise AssertionError("sharding: the unsharded fused encode differs from phase 7b's")
    frames_t = [device_parse(cfg, NBYTES, p) for p in pay]
    parsed = ParsedFrames(**{k.name: torch.stack([getattr(fr, k.name) for fr in frames_t])
                             for k in dataclasses.fields(ParsedFrames)})  # [T, S, ...]

    lines = []
    for devices in (["cuda:0"], ["cuda:0", "cuda:0"]):
        mesh = parallel.stream_mesh(devices)
        n = mesh.size
        label = f"mesh x{n}"
        dec_n, enc_n = step_launches("parsed", n=n * T), step_launches("fields", n=n * T)

        def fused_decode():
            step = parallel.make_sharded_decode_bytes_step(cfg, NBYTES, mesh)
            st, out = parallel.sharded_decoder_init(cfg, S, mesh), []
            for f in range(T):  # the payloads sharded from the host (pinned copies)
                st, p = step(st, parallel.shard_streams(mesh, pay_np[f]))
                out.append(p.gather(dev))
            return st, torch.stack(out, 1)

        (st, got), c1 = counted(f"{label} fused decode", step_launches("decode", n=n * T),
                                fused_decode)
        if not torch.equal(got, ref_pcm):
            raise AssertionError(f"{label}: the sharded fused decode differs from phase 5's PCM")
        same(f"{label} fused decode state", st.gather(dev), st_d)

        run = parallel.make_sharded_decode_frames(cfg, NBYTES * 8, mesh)
        (st, got), c2 = counted(f"{label} decode_frames", dec_n, lambda: run(
            parallel.sharded_decoder_init(cfg, S, mesh), parsed))
        if not torch.equal(got.gather(dev).transpose(0, 1), ref_pcm):
            raise AssertionError(f"{label}: the sharded decode_frames differs from phase 5's PCM")
        same(f"{label} decode_frames state", st.gather(dev), st_d)

        def encode():
            step = parallel.make_sharded_encode_step(cfg, NBYTES, mesh)
            st, out = parallel.sharded_encoder_init(cfg, S, mesh), []
            for f in range(T):
                st, fields = step(st, pcm_in[f])
                out.append(fields.gather(dev))
            return st, out

        (st, got), c3 = counted(f"{label} encode step", enc_n, encode)
        for f in range(T):
            same(f"{label} encode step frame {f}", got[f], ref_fields[f])
            packed_equal(f"{label} encode step", got[f], f)
        same(f"{label} encode step state", st.gather(dev), st_e)

        run = parallel.make_sharded_encode_frames(cfg, NBYTES, mesh)
        (st, got), c4 = counted(f"{label} encode_frames", enc_n, lambda: run(
            parallel.sharded_encoder_init(cfg, S, mesh), pcm_in))
        got = got.gather(dev)
        for f in range(T):
            per = {k: v[f] if torch.is_tensor(v) else v for k, v in got.items()}
            same(f"{label} encode_frames frame {f}", per, ref_fields[f])
            packed_equal(f"{label} encode_frames", per, f)
        same(f"{label} encode_frames state", st.gather(dev), st_e)

        def fused_encode():
            step = parallel.make_sharded_encode_bytes_step(cfg, NBYTES, mesh)
            st, out = parallel.sharded_encoder_init(cfg, S, mesh), []
            for f in range(T):
                st, b = step(st, pcm_in[f])
                out.append(b.gather())
            return st, np.stack([b.numpy() for b in out], 1)

        (st, got), c5 = counted(f"{label} fused encode", step_launches("bytes", n=n * T),
                                fused_encode)
        if not np.array_equal(got, want_fused):
            raise AssertionError(f"{label}: the sharded fused encode's bytes differ from "
                                 "BatchEncoder(device_pack=True)'s")
        same(f"{label} fused encode state", st.gather(dev), st_f)
        lines.append(f"{label}: fused decode (launches {c1}) and decode_frames ({c2}) = phase 5; "
                     f"encode step ({c3}) and encode_frames ({c4}) fields = unsharded, packed = "
                     f"the oracle's; fused encode ({c5}) = phase 7b; every state gathered = "
                     "unsharded")
    log("sharding", f"S={S} T={T}, bench content {took()}: " + "; ".join(lines))

    ranks = two_processes()
    got_pcm = np.concatenate([r["pcm"] for r in ranks])
    got_bytes = np.concatenate([r["frames"] for r in ranks])
    if not np.array_equal(got_pcm, want_pcm) or not np.array_equal(got_bytes, want_fused):
        raise AssertionError("two processes: the concatenated halves differ from the one-process "
                             "outputs")
    log("sharding-processes", f"2 processes (gloo, 127.0.0.1) on one card, {S // 2} streams each "
        f"{took()}: "
        f"fused decode and fused encode halves = the one-process PCM and bytes; launches "
        + "; ".join(f"rank {i} {r['counts']}" for i, r in enumerate(ranks)))

    # ---- profiling: device_step_ms beside tools/torch_profile.py's busy per step
    dec = BatchDecoder(cfg, S, NBYTES, device="cuda")
    enc = BatchEncoder(cfg, S, NBYTES, device="cuda")
    fenc = BatchEncoder(cfg, S, NBYTES, device="cuda", device_pack=True)
    # (the step and its profiled steps: an encode step's 6,800 launches make a
    # profile of 10 take seconds to read, so those take 5)
    steps = {"fused decode": (dec, lambda d, x: (d, d.decode_tensor(x)), pay[0], 10),
             "encode DSP": (enc, lambda e, x: (e, e.encode_fields_tensor(x)), pcm_in[0], 5),
             "fused encode": (fenc, lambda e, x: (e, e.encode_tensor(x)), pcm_in[0], 5)}
    lines = []
    for name, (obj, fn, x, n) in steps.items():
        ms = profiling.device_step_ms(fn, obj, (x,), steps=n)
        busy = torch_profile.device_profile(lambda: fn(obj, x), n)
        lines.append(f"{name} device_step_ms {ms:.4f} ms vs torch_profile busy "
                     f"{busy['busy_ms']:.4f} ms/step ({busy['launches']:.0f} launches, "
                     f"{n} steps each) {took()}")
    # the pipelined host-parse loop of bench.py:174-183: its span on the
    # card under the profiler, beside the host wall of the same loop with
    # the profiler on and off, alternated over 3 reps
    hp = BatchDecoder(cfg, S, NBYTES, device="cuda", device_parse=False)
    hp.decode_stream(pay_np[:2], fetch=False)  # warm-up
    M = 24
    loop = lambda: hp.decode_stream([pay_np[f % T] for f in range(M)], fetch=False,
                                    pipeline=True)  # returns once the last batch is computed
    walls = {"span": [], "profiled wall": [], "wall": []}

    def walled(key):
        w0 = time.perf_counter()
        loop()
        walls[key].append((time.perf_counter() - w0) * 1e3)

    for _ in range(3):
        torch.cuda.synchronize()
        walled("wall")
        walls["span"].append(profiling.device_loop_span_ms(lambda: walled("profiled wall")))
    rt = lambda ms: M * S * (cfg.nf / cfg.fs) / (float(np.median(ms)) / 1e3)
    lines.append(f"decode_stream(pipeline=True, fetch=False) host parse over {M} batches, median "
                 "of 3 alternated: " + ", ".join(f"{k} {spread(v)} ms = {rt(v):.1f}x realtime"
                                                 for k, v in walls.items())
                 + f" (phase 8d host wall, 48 batches: {stream_rt['pipelined']:.1f}x) {took()}")
    log("profiling", f"{card}, S={S}, 48k/10ms/150B: " + "; ".join(lines))

    # ---- times: the sharded fused decode step at both meshes beside decode_tensor
    fns = {"decode_tensor": lambda: dec.decode_tensor(pay[0])}
    for devices in (["cuda:0"], ["cuda:0", "cuda:0"]):
        mesh = parallel.stream_mesh(devices)
        step = parallel.make_sharded_decode_bytes_step(cfg, NBYTES, mesh)
        held = {"st": parallel.sharded_decoder_init(cfg, S, mesh),
                "x": parallel.shard_streams(mesh, pay[0])}

        def one(step=step, held=held):
            held["st"], _ = step(held["st"], held["x"])

        fns[f"sharded x{mesh.size}"] = one
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    ev = {k: [] for k in fns}
    for _ in range(REPS):
        for k, fn in fns.items():
            ev[k].append(event_ms(fn))
    log("sharding-times", f"{card}, S={S}, 48k/10ms/150B, CUDA events, {REPS} reps alternated, "
        "median [min-max]: " + "; ".join(f"{k} {spread(v)} ms" for k, v in ev.items())
        + f" {took()}")

def kernels_seen(fn, reps: int = 5) -> dict:
    """The launches of each of the kernels that torch.profiler sees in
    one call of fn (0 where it sees none), read per call over reps + 1
    calls (lc3jax_torch.profiling.call_spans, each call between two edge
    kernels on the card); the first call is not read (before the profile's
    warm-up step, a profile lost the first launches of a replayed graph in
    it), and the others must agree, or the profile is taken again."""
    import re

    from lc3jax_torch import profiling

    count = lambda spans: {k: sum(1 for _, _, n in spans
                                  if re.search(rf"(?<![A-Za-z_]){glob}", n))
                           for k, (_, glob, *_) in KERNELS.items()}
    per = profiling.call_spans(fn, reps + 1, check=lambda per: all(
        count(p) == count(per[1]) for p in per[2:]))
    return count(per[1])


def pool_bytes(pool) -> int:
    """Bytes of the card's memory segments in a graph memory pool."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def two_streams(card: str, cfg, bench, took) -> None:
    """Phase 11's two streams at S = 1024 (the bench content's streams
    0-1023 and 1024-2047 of shard_tile, so that they differ) run
    interleaved, frame by frame, through one make_decode_step, one
    make_encode_step, one make_decode_bytes_step and one sharded fused
    decode at mesh ["cuda:0"]: each stream's outputs and state torch.equal
    to its own eager stream after every frame; each step copies each
    stream's state in once, makes one static state slot and one graph a
    stream; the captures' ms and the pools' MiB after the first stream's
    graph and after the second's."""
    import torch

    from lc3jax_torch import parallel
    from lc3jax_torch.coding.device import (decode_bytes_step, device_parse,
                                            make_decode_bytes_step)
    from lc3jax_torch.compiled import leaves, tree_map
    from lc3jax_torch.dsp.decoder import decoder_init, make_decode_step
    from lc3jax_torch.dsp.encoder import encode_step, encoder_init, make_encode_step

    dev = torch.device("cuda", 0)
    S, T = S_MAIN // 2, T_FRAMES
    tile = shard_tile(S_MAIN)
    streams = {k: tile[i * S:(i + 1) * S] for i, k in enumerate("ab")}
    pay = {k: [torch.as_tensor(np.ascontiguousarray(bench["frames"][t, f]), device=dev)
               for f in range(T)] for k, t in streams.items()}
    pcm_in = {k: [torch.as_tensor(np.ascontiguousarray(bench["pcm_in"][t, f]), device=dev)
                  for f in range(T)] for k, t in streams.items()}
    snap = lambda st: tree_map(torch.clone, st)
    ref = {}
    for k in "ab":  # the eager streams, one at a time
        sd, se, ref[k] = decoder_init(cfg, S, dev), encoder_init(cfg, S, dev), []
        for f in range(T):
            sd, pcm = decode_bytes_step(cfg, NBYTES, sd, pay[k][f])
            se, fields = encode_step(cfg, NBYTES, se, pcm_in[k][f])
            ref[k].append(((snap(sd), pcm), (snap(se), fields)))
    mesh = parallel.stream_mesh(["cuda:0"])
    sharded = parallel.make_sharded_decode_bytes_step(cfg, NBYTES, mesh)
    paths = {
        "make_decode_step": (make_decode_step(cfg, NBYTES * 8),
                             lambda k, f: device_parse(cfg, NBYTES, pay[k][f]),
                             lambda: decoder_init(cfg, S, dev), 0),
        "make_encode_step": (make_encode_step(cfg, NBYTES), lambda k, f: pcm_in[k][f],
                             lambda: encoder_init(cfg, S, dev), 1),
        "make_decode_bytes_step": (make_decode_bytes_step(cfg, NBYTES),
                                   lambda k, f: pay[k][f], lambda: decoder_init(cfg, S, dev),
                                   0),
        "sharded fused decode x1": (sharded, lambda k, f: parallel.shard_streams(
            mesh, pay[k][f]), lambda: parallel.sharded_decoder_init(cfg, S, mesh), 0),
    }
    read = lambda t: t.gather(dev) if isinstance(t, parallel.Sharded) else t
    # make_decode_step's parse runs eagerly before the step: the same counts
    n_dec = step_launches("decode", n=2 * T)
    lines = []
    for name, (step, arg, init, which) in paths.items():
        inner = getattr(step, "steps", [step])[0]
        pools = []

        def run(step=step, arg=arg, init=init, which=which, inner=inner, pools=pools):
            st = {k: init() for k in "ab"}
            for f in range(T):
                for k in "ab":
                    st[k], out = step(st[k], arg(k, f))
                    same(f"two streams, {name}, stream {k} frame {f}",
                         (read(st[k]), read(out)), ref[k][f][which])
                    if f == 0:
                        pools.append(pool_bytes(inner.cache.pool))
                if st["a"] is st["b"]:
                    raise AssertionError(f"two streams, {name}: one state object")

        expect = n_dec if which == 0 else step_launches("fields", n=2 * T)
        _, n = counted(f"two streams, {name}", expect, run)
        got = (inner.captures, inner.calls, inner.state_copies, len(inner.cache.states),
               len(inner.graphs))
        if got != (2, 2 * T, 2, 2, 2):
            raise AssertionError(f"two streams, {name}: (captures, calls, state copies, "
                                 f"static states, graphs) {got}, not (2, {2 * T}, 2, 2, 2)")
        slot_mib = sum(t.numel() * t.element_size() for t in leaves(inner.cache.states[1])
                       if torch.is_tensor(t)) / 2**20
        lines.append(f"{name}: captures {inner.captures}, static states "
                     f"{len(inner.cache.states)}, graphs {len(inner.graphs)}, capture ms "
                     + "/".join(f"{g.capture_ms:.1f}" for g in inner.graphs)
                     + f", pool MiB {pools[0] / 2**20:.1f} -> {pools[1] / 2**20:.1f}, "
                     f"second static state {slot_mib:.1f} MiB (launches {n})")
    log("compiled-two-streams", f"{card}, S={S} each, T={T}, {NBYTES} B, interleaved: each "
        "stream = its own eager stream, state included, after every frame; " + "; ".join(lines)
        + f" {took()}")


def compiled_phase(card: str, cfg, bench) -> None:
    """Phase 11: every compiled path held torch.equal to its eager step
    function, outputs and state after every frame, at S = 2048 on the bench
    content over T frames (the corrupt frame included) with nbytes 150 ->
    100 -> 150 -> 100 inside the run (three switches, so that the steps made
    one a frame size hand the state back and forth); each key captured
    once; the kernels the profiler sees in one replay of every graph equal
    to the eager step's launches; nodes and capture time per graph; eager
    against replayed times; the graphs' memory."""
    import torch

    from lc3jax_torch import parallel
    from lc3jax_torch.coding.device import (decode_bytes_step, decode_bytes_step_stats,
                                            device_parse, encode_bytes_step,
                                            make_decode_bytes_step)
    from lc3jax_torch.coding.host_parse import HostParser
    from lc3jax_torch.compiled import tree_map
    from lc3jax_torch.dsp.decoder import decode_step, decoder_init, make_decode_step
    from lc3jax_torch.dsp.encoder import encode_step, encoder_init, make_encode_step
    from lc3jax_torch.dsp.streaming import decode_bytes_frames
    from lc3jax_torch.serving import BatchDecoder, BatchEncoder

    dev = torch.device("cuda", 0)
    S, T = S_MAIN, T_FRAMES
    t0 = time.perf_counter()
    took = lambda: f"({time.perf_counter() - t0:.1f} s into the phase)"
    tile = np.arange(S) % 4
    # three switches, each on a chunk of 2; frame 5 holds the corrupt frame
    plan = [NBYTES] * 6 + [100] * 2 + [NBYTES] * 2 + [100] * 2
    snap = lambda st: tree_map(torch.clone, st)
    pcm_in = [torch.as_tensor(np.ascontiguousarray(bench["pcm_in"][tile, f]), device=dev)
              for f in range(T)]

    # ---- the eager references, frame by frame
    st, ref_fields, ref_estate = encoder_init(cfg, S, dev), [], []
    for x, nb in zip(pcm_in, plan):
        st, fields = encode_step(cfg, nb, st, x)
        ref_fields.append(fields)
        ref_estate.append(snap(st))
    st, ref_bytes, ref_fstate = encoder_init(cfg, S, dev), [], []
    for x, nb in zip(pcm_in, plan):
        st, b = encode_bytes_step(cfg, nb, st, x)
        ref_bytes.append(b)
        ref_fstate.append(snap(st))
    # the bench's own frames at 150 B, the fused encode's at 100 B
    pay_np = [np.ascontiguousarray(bench["frames"][tile, f]) if nb == NBYTES
              else ref_bytes[f].cpu().numpy() for f, nb in enumerate(plan)]
    pay = [torch.as_tensor(p, device=dev) for p in pay_np]
    st, ref_pcm, ref_dstate, n_bad = decoder_init(cfg, S, dev), [], [], 0
    for x, nb in zip(pay, plan):
        st, pcm, bad = decode_bytes_step_stats(cfg, nb, st, x)
        ref_pcm.append(pcm)
        ref_dstate.append(snap(st))
        n_bad += int(bad)
    if n_bad != S // 4:
        raise AssertionError(f"compiled: the eager decode concealed {n_bad} frames, not {S // 4}")
    parser = HostParser(cfg, dev)
    st, ref_host, ref_hstate = decoder_init(cfg, S, dev), [], []
    for x, nb in zip(pay_np, plan):
        parser.parse(x)
        st, pcm = decode_step(cfg, nb * 8, st, parser.upload())
        ref_host.append(pcm)
        ref_hstate.append(snap(st))

    def per_frame(label, outs, states, ref_out, ref_st):
        for f in range(T):
            same(f"{label} frame {f}", outs[f], ref_out[f])
            same(f"{label} state after frame {f}", states[f], ref_st[f])

    def once(label, steps, calls):
        """Each key captured once, the rest replays; the coder's own state
        never copied."""
        got = {k: (s.captures, s.calls, s.state_copies) for k, s in steps.items()}
        if got != {k: (1, n, 0) for k, n in calls.items()}:
            raise AssertionError(f"{label}: steps (captures, calls, state copies) {got}")

    calls_of = {nb: plan.count(nb) for nb in (NBYTES, 100)}  # 8 and 4
    plan_calls = lambda kind, T=None: {(kind, nb, *(() if T is None else (T,))): n
                                       for nb, n in calls_of.items()}
    lines = []
    dec_n, fused_n = step_launches("parsed", n=T), step_launches("decode", n=T)

    # fused decode (decode_tensor)
    dec = BatchDecoder(cfg, S, NBYTES, device="cuda")

    def run_dec():
        outs, states = [], []
        for x in pay:
            outs.append(dec.decode_tensor(x))
            states.append(snap(dec.state))
        return outs, states

    (outs, states), n = counted("compiled fused decode", fused_n, run_dec)
    per_frame("fused decode", outs, states, ref_pcm, ref_dstate)
    once("fused decode", dec.steps, plan_calls("stats", 0))
    if dec.metrics.plc_frames != S // 4 or len({o.data_ptr() for o in outs}) != T:
        raise AssertionError(f"fused decode: plc_frames {dec.metrics.plc_frames}, or results "
                             "share memory")
    lines.append(f"fused decode (launches {n})")

    # host-parse decode
    hp = BatchDecoder(cfg, S, NBYTES, device="cuda", device_parse=False)

    def run_host():
        outs, states = [], []
        for x in pay_np:
            outs.append(torch.as_tensor(hp.decode(x), device=dev))
            states.append(snap(hp.state))
        return outs, states

    (outs, states), n = counted("compiled host-parse decode", dec_n, run_host)
    per_frame("host-parse decode", outs, states, ref_host, ref_hstate)
    once("host-parse decode", hp.steps, plan_calls("parsed", 0))
    lines.append(f"host-parse decode (launches {n})")

    # decode_stream: chunks of 2 across the rate changes (6 chunks, 2 keys),
    # and one chunk of 12 over the bench's own frames against eager decode_bytes_frames
    d2 = BatchDecoder(cfg, S, NBYTES, device="cuda")
    outs, n = counted("compiled decode_stream chunk_frames=2", fused_n,
                      lambda: d2.decode_stream(iter(pay_np), fetch=False, chunk_frames=2))
    for f in range(T):
        same(f"decode_stream chunk_frames=2 frame {f}", outs[f], ref_pcm[f])
    same("decode_stream chunk_frames=2 state", d2.state, ref_dstate[-1])
    once("decode_stream chunk_frames=2", d2.steps,
         {("chunk", nb, 2): n // 2 for nb, n in calls_of.items()})
    bench12 = np.stack([np.ascontiguousarray(bench["frames"][tile, f]) for f in range(T)])
    want_st, want12 = decode_bytes_frames(cfg, NBYTES, decoder_init(cfg, S, dev),
                                          torch.as_tensor(bench12, device=dev))
    d12 = BatchDecoder(cfg, S, NBYTES, device="cuda")
    outs, n12 = counted("compiled decode_stream chunk_frames=12", fused_n,
                        lambda: d12.decode_stream(list(bench12), chunk_frames=12))
    same("decode_stream chunk_frames=12", [torch.as_tensor(o, device=dev) for o in outs],
         list(want12.unbind(0)))
    same("decode_stream chunk_frames=12 state", d12.state, want_st)
    once("decode_stream chunk_frames=12", d12.steps, {("chunk", NBYTES, 12): 1})
    lines.append(f"decode_stream chunk_frames=2 across the rate changes (launches {n}) and "
                 f"chunk_frames=12 = eager decode_bytes_frames (launches {n12})")

    # make_decode_step / make_encode_step, one a frame size, the state handed on
    dsteps = {nb: make_decode_step(cfg, nb * 8) for nb in (NBYTES, 100)}
    esteps = {nb: make_encode_step(cfg, nb) for nb in (NBYTES, 100)}
    sd, se = decoder_init(cfg, S, dev), encoder_init(cfg, S, dev)
    for f, nb in enumerate(plan):
        sd, pcm = dsteps[nb](sd, device_parse(cfg, nb, pay[f]))
        same(f"make_decode_step frame {f}", (sd, pcm), (ref_dstate[f], ref_pcm[f]))
        se, fields = esteps[nb](se, pcm_in[f])
        same(f"make_encode_step frame {f}", (se, fields), (ref_estate[f], ref_fields[f]))
    made = {**{("decode", nb): s for nb, s in dsteps.items()},
            **{("encode", nb): s for nb, s in esteps.items()}}
    if any((s.captures, s.calls) != (1, calls_of[k[1]]) for k, s in made.items()):
        raise AssertionError("make_*_step: " + str({k: (s.captures, s.calls)
                                                     for k, s in made.items()}))
    lines.append("make_decode_step and make_encode_step (state copies at each switch: "
                 + ", ".join(f"{k[0]} {k[1]} B {s.state_copies}" for k, s in made.items()) + ")")

    # make_decode_bytes_step, one a frame size, the state handed on
    bsteps = {nb: make_decode_bytes_step(cfg, nb) for nb in (NBYTES, 100)}

    def run_bytes():
        sb = decoder_init(cfg, S, dev)
        for f, nb in enumerate(plan):
            sb, pcm = bsteps[nb](sb, pay[f])
            same(f"make_decode_bytes_step frame {f}", (sb, pcm), (ref_dstate[f], ref_pcm[f]))

    _, n = counted("compiled make_decode_bytes_step", fused_n, run_bytes)
    if any((s.captures, s.calls, len(s.cache.states)) != (1, calls_of[nb], 1)
           for nb, s in bsteps.items()):
        raise AssertionError("make_decode_bytes_step: " + str(
            {nb: (s.captures, s.calls, len(s.cache.states)) for nb, s in bsteps.items()}))
    lines.append(f"make_decode_bytes_step (launches {n}, state copies "
                 + ", ".join(f"{nb} B {s.state_copies}" for nb, s in bsteps.items()) + ")")

    # encode DSP and fused encode
    encoders = {}
    for fused in (False, True):
        e = encoders[fused] = BatchEncoder(cfg, S, NBYTES, device="cuda", device_pack=fused)

        def run_enc(e=e, fused=fused):
            outs, states = [], []
            for x, nb in zip(pcm_in, plan):
                outs.append(e.encode_tensor(x, nb) if fused else e.encode_fields_tensor(x, nb))
                states.append(snap(e.state))
            return outs, states

        (outs, states), n = counted(f"compiled {'fused encode' if fused else 'encode DSP'}",
                                    step_launches("bytes" if fused else "fields", n=T), run_enc)
        label = "fused encode" if fused else "encode DSP"
        per_frame(label, outs, states, ref_bytes if fused else ref_fields,
                  ref_fstate if fused else ref_estate)
        once(label, e.steps, plan_calls("bytes" if fused else "fields"))
        lines.append(f"{label} (launches {n})")

    # the sharded fused decode at both meshes, one sharded step a frame size
    sharded = {}
    for devices in (["cuda:0"], ["cuda:0", "cuda:0"]):
        mesh = parallel.stream_mesh(devices)
        steps = sharded[mesh.size] = {nb: parallel.make_sharded_decode_bytes_step(cfg, nb, mesh)
                                      for nb in (NBYTES, 100)}

        def run_sharded(steps=steps, mesh=mesh):
            st, outs, states = parallel.sharded_decoder_init(cfg, S, mesh), [], []
            for x, nb in zip(pay_np, plan):
                st, p = steps[nb](st, parallel.shard_streams(mesh, x))
                outs.append(p.gather(dev))
                states.append(st.gather(dev))
            return outs, states

        k = mesh.size
        (outs, states), n = counted(f"compiled sharded x{k}", step_launches("decode", n=k * T),
                                    run_sharded)
        per_frame(f"sharded fused decode x{k}", outs, states, ref_pcm, ref_dstate)
        caps = [(s.captures, s.calls) for st_ in steps.values() for s in st_.steps]
        if caps != [(1, calls_of[NBYTES])] * k + [(1, calls_of[100])] * k:
            raise AssertionError(f"sharded x{k}: (captures, calls) per shard {caps}")
        lines.append(f"sharded fused decode x{k} (launches {n})")
    log("compiled", f"S={S} T={T}, nbytes {plan}, the corrupt frame included: every compiled "
        "path = its eager step, each output and the state after every frame (torch.equal), each "
        f"key captured once, no state copy in serving: " + "; ".join(lines) + f" {took()}")
    two_streams(card, cfg, bench, took)

    # ---- per graph: the kernels the profiler sees in one replay, nodes, capture ms
    parser.parse(pay_np[0])
    frames0 = parser.upload()
    graphs = {
        "fused decode": (dec.steps[("stats", NBYTES, 0)], (pay[0],), step_launches("decode")),
        "host-parse decode step": (hp.steps[("parsed", NBYTES, 0)], (frames0,),
                                   step_launches("parsed")),
        "chunk of 12": (d12.steps[("chunk", NBYTES, 12)],
                        (torch.as_tensor(bench12, device=dev),), step_launches("decode", n=T)),
        "encode DSP": (encoders[False].steps[("fields", NBYTES)], (pcm_in[0],),
                       step_launches("fields")),
        "fused encode": (encoders[True].steps[("bytes", NBYTES)], (pcm_in[0],),
                         step_launches("bytes")),
    }
    # the steps made one a frame size, on the inputs their graphs last took
    graphs.update({f"make_decode_step {nb} B": (s, s.buffers(), step_launches("parsed"))
                   for nb, s in dsteps.items()})
    graphs.update({f"make_encode_step {nb} B": (s, s.buffers(), step_launches("fields"))
                   for nb, s in esteps.items()})
    graphs.update({f"make_decode_bytes_step {nb} B": (s, s.buffers(), step_launches("decode"))
                   for nb, s in bsteps.items()})
    graphs.update({f"sharded x{k} {nb} B shard {i}": (s, s.buffers(), step_launches("decode"))
                   for k, steps in sharded.items() for nb, st_ in steps.items()
                   for i, s in enumerate(st_.steps)})
    lines = []
    for name, (step, args, eager) in graphs.items():
        # by kernel name, as the profiler sees them: the fused encode's
        # emit_pack launch is one of its bitmodel_table_part launches
        eager = {k: v for k, v in eager.items() if k in KERNELS}
        g = step.graphs[0]
        recorded = {k: v for k, v in launch_counts(g.counts).items() if v}
        seen = kernels_seen(lambda: step.run(step.cache.state, *args))
        seen = {k: v for k, v in seen.items() if v}
        if recorded != eager or seen != eager:
            raise AssertionError(f"{name}: the capture recorded {recorded} and the profiler "
                                 f"sees {seen} in one replay; the eager step launches {eager}")
        lines.append(f"{name}: replay launches {seen}, {step.node_counts()[0]} nodes, "
                     f"captured in {g.capture_ms:.1f} ms")
    pools = {"decoder": dec, "host-parse decoder": hp, "encoder": encoders[False],
             "fused encoder": encoders[True]}
    lines.append("graph pools " + ", ".join(
        f"{k} {pool_bytes(o._steps.pool) / 2**20:.1f} MiB" for k, o in pools.items())
        + f"; reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB")
    log("compiled-graphs", f"{card}: " + "; ".join(lines) + f" {took()}")

    # ---- times: eager step against replay, alternated, median [min-max] of REPS
    st_e, st_ee = decoder_init(cfg, S, dev), encoder_init(cfg, S, dev)
    hframes = parser.upload()
    pairs = {
        "fused decode": (lambda: decode_bytes_step_stats(cfg, NBYTES, st_e, pay[0]),
                         lambda: dec.steps[("stats", NBYTES, 0)](dec.state, pay[0])),
        "host-parse decode step": (
            lambda: decode_step(cfg, NBYTES * 8, st_e, hframes),
            lambda: hp.steps[("parsed", NBYTES, 0)].run(hp.state, *hp.steps[
                ("parsed", NBYTES, 0)].buffers())),
        "encode DSP": (lambda: encode_step(cfg, NBYTES, st_ee, pcm_in[0]),
                       lambda: encoders[False].encode_fields_tensor(pcm_in[0])),
        "fused encode": (lambda: encode_bytes_step(cfg, NBYTES, st_ee, pcm_in[0]),
                         lambda: encoders[True].encode_tensor(pcm_in[0])),
    }
    out = {}
    for name, fns in pairs.items():
        ev, wall = ([], []), ([], [])
        for r in range(3 + REPS):
            for i, fn in enumerate(fns):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                w0 = time.perf_counter()
                a.record()
                fn()
                b.record()
                b.synchronize()
                if r >= 3:
                    ev[i].append(a.elapsed_time(b))
                    wall[i].append((time.perf_counter() - w0) * 1e3)
        out[name] = (ev, wall)
    rt = lambda ms: S * (cfg.nf / cfg.fs) / (float(np.median(ms)) / 1e3)
    log("compiled-times", f"{card}, S={S}, 48k/10ms/150B, eager and replay alternated, "
        f"{REPS} reps, median [min-max] ms (x realtime of the median): " + "; ".join(
            f"{k} eager events {spread(ev[0])} wall {spread(wall[0])} ({rt(wall[0]):.1f}x), "
            f"replay events {spread(ev[1])} wall {spread(wall[1])} ({rt(wall[1]):.1f}x)"
            for k, (ev, wall) in out.items()) + f" {took()}")

    # ---- decode_stream over 48 batches in each device-parse mode, against
    # the same loops of eager steps (the serving loop before the graphs)
    many = [pay_np[f % 6] for f in range(4 * T)]  # the 150 B frames
    audio = len(many) * S * cfg.nf / cfg.fs
    to_dev = lambda b: torch.as_tensor(b).pin_memory().to(dev, non_blocking=True)

    def eager_loop(mode):
        st = decoder_init(cfg, S, dev)
        if mode == "chunk_frames=12":
            for i in range(0, len(many), T):
                st, pcm = decode_bytes_frames(cfg, NBYTES, st, to_dev(np.stack(many[i:i + T])))
                pcm.cpu().numpy()
            return
        for b in many:
            if mode == "fetch=True":
                st, pcm, bad = decode_bytes_step_stats(cfg, NBYTES, st, to_dev(b))
                pcm.cpu().numpy()
                int(bad)
            else:
                st, pcm = decode_bytes_step(cfg, NBYTES, st, to_dev(b))
        torch.cuda.synchronize()

    kw = {"fetch=True": {}, "fetch=False": {"fetch": False}, "chunk_frames=12": {"chunk_frames": 12}}
    decs = {k: BatchDecoder(cfg, S, NBYTES, device="cuda") for k in kw}
    walls = {(k, w): [] for k in kw for w in ("eager", "replay")}
    for r in range(STREAM_REPS + 1):
        for k in kw:
            for w in ("eager", "replay"):
                torch.cuda.synchronize()
                w0 = time.perf_counter()
                if w == "eager":
                    eager_loop(k)
                else:
                    decs[k].decode_stream(iter(many), **kw[k])
                if r:
                    walls[(k, w)].append((time.perf_counter() - w0) * 1e3)
    xrt = lambda ms: audio / (float(np.median(ms)) / 1e3)
    log("compiled-stream", f"{card}, S={S}, decode_stream over {len(many)} batches, device "
        f"parse, eager loop and compiled decode_stream alternated, {STREAM_REPS} reps, median "
        "[min-max] ms host wall: " + "; ".join(
            f"{k} {w} {spread(v)} = {xrt(v):.1f}x realtime" for (k, w), v in walls.items())
        + f" {took()}")


def api_phase(card: str, cfg, s50) -> None:
    """Phase 12: lc3jax_torch.api on the card. The three buffer calculators
    at 48 kHz / 10 ms, one channel (decoder_ram_bytes = 27,564); a
    two-channel Lc3Encoder / Lc3Decoder over stream50 at 120 B, the
    channels called interleaved: channel 0 encodes stream50 to the
    oracle's frames and decodes them within 1 LSB and at >= 100 dB of its
    PCM, channel 1 decodes stream50 with a corrupt, a truncated (10 B) and
    an empty frame within 1 LSB of the oracle (tests/goldens/torch_api.npz,
    tools/gen_torch_api_goldens.py), those three concealed, the launch
    counts zeroed before and read after; decode_frame(24, ...) raises
    ValueError; the parse kernel at 0, 1, 2 and 3 B against its plain
    version at S = 2048 and S = 1 (every field equal, every frame bad); a
    fused decode at S = 2048 over channel 1's first 10 frames, the empty
    batch included (PCM within 1 LSB of the oracle, plc_frames 3 S); the
    facade's host wall per frame and channel."""
    import torch

    from lc3jax_torch import api
    from lc3jax_torch.config import FrameDuration
    from lc3jax_torch.serving import BatchDecoder

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    took = lambda: f"({time.perf_counter() - t0:.1f} s into the phase)"
    ms10 = FrameDuration.MS10
    calc = (api.decoder_calc_working_buffer_lengths(1, ms10, 48000),
            api.decoder_ram_bytes(1, ms10, 48000),
            api.encoder_calc_working_buffer_lengths(1, ms10, 48000))
    if calc[1] != 27564:
        raise AssertionError(f"api: decoder_ram_bytes {calc[1]}, not 27,564")

    lossy = np.load(ROOT / "tests" / "goldens" / "torch_api.npz")
    frames1 = [bytes(p[:n]) for p, n in zip(lossy["lossy_payloads"], lossy["lossy_nbytes"])]
    T = len(frames1)
    enc = api.Lc3Encoder(2, ms10, 48000)
    dec = api.Lc3Decoder(2, ms10, 48000)
    walls = {"encode_frame": [], "decode_frame": []}

    def timed(kind, fn, *args):
        w0 = time.perf_counter()
        out = fn(*args)
        walls[kind].append((time.perf_counter() - w0) * 1e3)
        return out

    def run():
        pcm0, pcm1 = [], []
        for f in range(T):
            out = timed("encode_frame", enc.encode_frame, 0, s50["pcm_in"][f], 120)
            if out != s50["payloads"][f].tobytes():
                raise AssertionError(f"api: channel 0 frame {f} differs from the oracle's")
            pcm0.append(timed("decode_frame", dec.decode_frame, 16, 0, out))
            pcm1.append(timed("decode_frame", dec.decode_frame, 16, 1, frames1[f]))
        return np.stack(pcm0), np.stack(pcm1)

    (pcm0, pcm1), n = counted("api facade", step_launches("decode", "decode", "fields", n=T), run)
    env0 = check_envelope("channel 0", pcm0, s50["pcm_out"])
    max1 = int(np.abs(pcm1.astype(np.int64) - lossy["lossy_pcm_out"]).max())
    plc = (dec.channels[0].metrics.plc_frames, dec.channels[1].metrics.plc_frames)
    if max1 > 1 or plc != (0, int(lossy["lossy_concealed"].sum())):
        raise AssertionError(f"api: channel 1 max {max1} LSB from the oracle, plc_frames {plc}")
    try:
        dec.decode_frame(24, 0, s50["payloads"][0].tobytes())
    except ValueError:
        pass
    else:
        raise AssertionError("api: decode_frame(24, ...) did not raise ValueError")

    # the parse kernel on frames of 0-3 bytes, every field, S = 2048 and 1
    rng = np.random.default_rng(12)
    for nb in (0, 1, 2, 3):
        for S in (S_MAIN, 1):
            x = rng.integers(0, 256, (S, nb), dtype=np.uint8)
            x[::7] = 255
            want = parse_equal(f"{nb} B, S={S}", cfg, nb, torch.as_tensor(x, device=dev))
            if not bool(want.bad_frame.all()):
                raise AssertionError(f"parse: a {nb} B frame was not bad")

    # a fused decode batch of 0 B at S = 2048, inside channel 1's stream
    bd = BatchDecoder(cfg, S_MAIN, 120)
    first = int(lossy["lossy_positions"].max()) + 1
    for f in range(first):
        batch = np.repeat(np.frombuffer(frames1[f], np.uint8)[None], S_MAIN, axis=0)
        pcm = bd.decode(batch)
        if np.abs(pcm.astype(np.int64) - lossy["lossy_pcm_out"][f]).max() > 1:
            raise AssertionError(f"fused decode at S={S_MAIN}: frame {f} ({len(frames1[f])} B) "
                                 "differs from the oracle by more than 1 LSB")
    n_plc = int(lossy["lossy_concealed"][:first].sum()) * S_MAIN
    if bd.metrics.plc_frames != n_plc or ("stats", 0, 0) not in bd.steps:
        raise AssertionError(f"fused decode at S={S_MAIN}: plc_frames {bd.metrics.plc_frames}, "
                             f"not {n_plc}")
    med = {k: float(np.median(v[2:])) for k, v in walls.items()}  # the captures left out
    log("api", f"{card}: decoder_calc_working_buffer_lengths {calc[0]}, decoder_ram_bytes "
        f"{calc[1]}, encoder_calc_working_buffer_lengths {calc[2]} (48 kHz / 10 ms, 1 channel); "
        f"2 channels interleaved over stream50 ({T} frames, 120 B; launches {n}): channel 0 "
        f"bytes = the oracle's, {env0}; channel 1 (corrupt, 10 B and 0 B frames at "
        f"{lossy['lossy_positions'].tolist()}) max {max1} LSB from the oracle, plc_frames "
        f"{plc[1]}; decode_frame(24) raises ValueError; the parse kernel = plain at 0-3 B, "
        f"S = {S_MAIN} and 1, every frame bad; fused decode at S={S_MAIN} with a 0 B batch = "
        f"the oracle, plc_frames {bd.metrics.plc_frames}; host wall a frame and channel, "
        "median of the run: " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
        + f" {took()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from lc3jax_torch import _build
    from lc3jax_torch.coding import device as cdev
    from lc3jax_torch.coding import host_pack, pack_kernel, parse_kernel
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.convert import decoder_tables, encoder_fields_to_numpy, encoder_tables
    from lc3jax_torch.dsp import bitmodel_kernel, ltpf_kernel, sns_kernel, tns_enc_kernel, tns_kernel
    from lc3jax_torch.dsp import decoder as D
    from lc3jax_torch.dsp import encoder_ltpf, gain_kernel, ltpf_enc_kernel, sns_analysis_kernel
    from lc3jax_torch.dsp.encoder import (encode_step, encoder_init, gain_bisection_plain,
                                          sns_finish_plain, sns_front_plain, tuple_symbols)
    from lc3jax_torch.dsp.ltpf import ltpf_pass_args
    from lc3jax_torch.serving import BatchDecoder, BatchEncoder

    sys.path.insert(0, str(ROOT / "tools"))
    import kernel_phases

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    gold = ROOT / "tests" / "goldens"
    bench = np.load(gold / "torch_bench_content.npz")
    corpus = np.load(gold / "corpus.npz")
    s50 = np.load(gold / "stream50.npz")

    # ---- 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("card", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
                f"{torch.cuda.device_count()} device(s)")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.lib()
    t1 = time.perf_counter()
    host_pack.load()
    log("build", f"{_build.library_path().name} in {t1 - t0:.1f} s (nvcc "
                 f"{_build.build_seconds if _build.build_seconds is not None else 'cached'}); "
                 f"host packer {host_pack.library_path().name} in {time.perf_counter() - t1:.1f} s")

    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    nbits = NBYTES * 8
    tab = decoder_tables(cfg, nbits, dev)
    tile = np.arange(S_MAIN) % 4

    # ---- 3. decode kernels against their plain versions, main-path shapes
    one = bench["encoded"][:, 0]  # the first frame of each content
    garbage = np.random.default_rng(1).integers(0, 256, (S_MAIN, NBYTES), dtype=np.uint8)
    mixed = np.where((np.arange(S_MAIN) % 2 == 0)[:, None], one[tile], garbage)
    payloads = torch.as_tensor(mixed, device=dev)
    bad_frame = parse_equal("bench + garbage", cfg, NBYTES, payloads).bad_frame
    n_bad = int(bad_frame.sum())
    if n_bad == 0 or bool(bad_frame[0::2].any()):
        raise AssertionError(f"parse: unexpected bad-frame pattern ({n_bad} bad)")
    errs = {"parse": 0.0}

    g = np.random.default_rng(2)
    x_t = torch.as_tensor((g.standard_normal((S_MAIN, cfg.ne)) * 1000).astype(np.float32), device=dev)
    bw_t = torch.as_tensor(g.integers(0, 5, S_MAIN).astype(np.int32), device=dev)
    ro_t = torch.as_tensor(g.integers(0, 9, (S_MAIN, 2)).astype(np.int32), device=dev)
    ri_t = torch.as_tensor(g.integers(0, 17, (S_MAIN, 16)).astype(np.int32), device=dev)
    tns_args = (tab, x_t, bw_t, ro_t, ri_t)
    yk = tns_kernel.tns_synthesis(*tns_args)
    yp = tns_kernel.tns_synthesis_plain(*tns_args)
    errs["tns_synthesis"] = float((yk - yp).abs().max())
    if not torch.equal(yk, yp):
        raise AssertionError(f"tns kernel != plain, max abs {errs['tns_synthesis']}")
    # the decode step's own arguments (the bench content's first frame), and
    # the shapes the chunking and the bounds can get wrong
    pay = torch.as_tensor(bench["frames"][tile, 0], device=dev)
    fr = cdev.device_parse(cfg, NBYTES, pay)
    real_tns = (tab, D.pre_tns(tab, fr), fr.bandwidth, fr.rc_order, fr.rc_i)
    tns_more = tns_cases(cfg, dev)
    for label, args in [("decode step S=2048", real_tns)] + [(k, v[0]) for k, v in tns_more.items()]:
        equal_outputs(f"tns_synthesis ({label})", tns_kernel.tns_synthesis(*args),
                      tns_kernel.tns_synthesis_plain(*args))

    # LTPF: the stress inputs of earlier runs (48 kHz / 10 ms at 150 B, where
    # the new coefficients are zero), the three shapes of the paths at rates
    # whose gain is on, the ragged edge, and the decode step's own arguments
    st, x_l, act_l, pi_l = ltpf_stress(tab.p, S_MAIN, 7, dev)
    lt_args = ltpf_pass_args(tab, st, x_l, act_l, pi_l)[0]
    lt_cases = {"48k/10ms 150B S=2048": lt_args}
    for label, c, nb, S, seed in (("48k/10ms 75B", cfg, 75, S_MAIN, 8),
                                  ("48k/7.5ms 56B", Lc3Config.new(48000, FrameDuration.MS7P5),
                                   56, S_MAIN, 9),
                                  ("8k/10ms 40B", Lc3Config.new(8000, FrameDuration.MS10),
                                   40, S_MAIN, 10),
                                  ("48k/10ms 75B S=2047", cfg, 75, S_MAIN - 1, 11),
                                  ("48k/10ms 75B S=1", cfg, 75, 1, 12)):
        t_c = decoder_tables(c, nb * 8, dev)
        lt_cases[label] = ltpf_pass_args(t_c, *ltpf_stress(t_c.p, S, seed, dev))[0]
    lt_main = capture_ltpf_inputs(cfg, [bench["frames"][tile, f] for f in range(2)])
    lt_cases["decode step S=2048"] = lt_main
    for label, a in lt_cases.items():
        equal_outputs(f"ltpf ({label})", ltpf_kernel.ltpf_both_passes(*a),
                      ltpf_kernel.ltpf_both_passes_plain(*a))
    errs["ltpf"] = 0.0
    log("kernels", f"parse: 19 fields equal ({n_bad}/{S_MAIN} bad frames); "
                   f"tns: equal on random 48k/10ms S=2048 inputs, the decode step's arguments, "
                   f"{', '.join(tns_more)}; "
                   f"ltpf: equal on {', '.join(lt_cases)}")

    # ---- 4. encoder kernels against their plain versions
    pcm_in = bench["pcm_in"]  # [4, T, nf]
    real = capture_kernel_inputs(cfg, torch.as_tensor(pcm_in[tile, 0], device=dev))
    g = np.random.default_rng(3)
    rnd = torch.as_tensor((g.standard_normal((S_MAIN, cfg.ne)) * 10 ** g.uniform(0, 3, (S_MAIN, 1)))
                          .astype(np.float32), device=dev)
    etab = encoder_tables(cfg, nbits, dev)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
    bw_r = i32(g.integers(0, 5, S_MAIN))
    rci_r = i32(g.integers(0, 17, (S_MAIN, 16)))
    ro_r = i32(g.integers(0, 9, (S_MAIN, 2)))
    nf_r = torch.where(bw_r >= 3, 2, 1).to(torch.int32)
    mag = g.standard_normal((S_MAIN, cfg.ne)) * 3
    xq_r = np.clip(mag.astype(np.int64) * (1 << g.integers(0, 15, (S_MAIN, cfg.ne))) // 8,
                   -32768, 32767).astype(np.int32)
    ts = tuple_symbols(torch.as_tensor(xq_r, device=dev))
    random_args = {
        "sns_pvq": (torch.as_tensor((g.standard_normal((S_MAIN, 16)) * 3).astype(np.float32),
                                    device=dev),),
        "tns_coefficients": (etab, rnd, bw_r, torch.as_tensor(g.integers(0, 8, S_MAIN) == 0,
                                                              device=dev), 0),
        "tns_analysis": (rnd, etab.tns_bounds[bw_r], ro_r, nf_r, etab.tns_sin[rci_r]),
        "bitmodel_table_part": (ts["c"], ts["g"], ts["sym"], 512, cfg.ne, ts["lastnz"]),
    }
    # the LTPF analysis, the gain estimate and the SNS analysis are held to
    # their plain versions by the card tests (tests/test_torch_ltpf_enc.py,
    # tests/test_torch_gain_estimate.py,
    # tests/test_torch_sns_analysis_kernel.py); phase 9 times them
    enc_fns = {
        "sns_pvq": (sns_kernel.sns_pvq, sns_kernel.sns_pvq_plain),
        "tns_coefficients": (tns_enc_kernel.tns_coefficients, tns_enc_kernel.tns_coefficients_plain),
        "tns_analysis": (tns_enc_kernel.tns_analysis, tns_enc_kernel.tns_analysis_plain),
        "bitmodel_table_part": (bitmodel_kernel.bitmodel_table_part,
                                bitmodel_kernel.bitmodel_table_part_plain),
        "ltpf_analysis": (ltpf_tuple(ltpf_enc_kernel.ltpf_analysis),
                          ltpf_tuple(encoder_ltpf.ltpf_analysis_plain)),
        "gain_estimate": (gain_kernel.gain_estimate, gain_bisection_plain),
        "sns_front": (sns_analysis_kernel.sns_front, sns_front_plain),
        "sns_finish": (sns_finish_tuple(sns_analysis_kernel.sns_finish),
                       sns_finish_tuple(sns_finish_plain)),
    }
    lines = []
    more = {"tns_coefficients": tns_coef_cases(dev),
            "tns_analysis": {k: v[1] for k, v in tns_more.items()},
            "sns_pvq": pvq_cases(dev), "bitmodel_table_part": bitmodel_cases(dev)}
    shapes = set(sns_kernel.sns_pvq_plain(*more["sns_pvq"][f"ties S={S_MAIN - 1}"])[3].tolist())
    if shapes != {0, 1, 2, 3}:
        raise AssertionError(f"pvq_cases reach shapes {sorted(shapes)}, not all four")
    x_o, _, ro_o, nf_o, ri_o = (torch.as_tensor(a, device=dev) for a in tns_random(cfg, S_MAIN, 25))
    more["tns_analysis"]["48k/10ms overlapping filters"] = (
        x_o, torch.as_tensor(overlapping_bounds(S_MAIN, cfg.ne, 26), device=dev), ro_o, nf_o,
        etab.tns_sin[ri_o.long()])
    for name, rnd_args in random_args.items():
        kern, plain = enc_fns[name]
        cases = [("random", rnd_args), ("bench", real[name])]
        cases += list(more.get(name, {}).items())
        for label, args in cases:
            equal_outputs(f"{name} ({label})", kern(*args), plain(*args))
        errs[name] = 0.0
        lines.append(f"{name}: equal" + (f" (also on {', '.join(more[name])})" if name in more else ""))
    torch.cuda.synchronize()
    log("enc-kernels", "; ".join(lines) + " (random and bench inputs, S=2048)")
    log("division", division_phase(card, dev))

    # ---- 4b. the bit model's emit_pack and the pack kernel against their plain versions
    bm = bitmodel_kernel
    for label, args in [("random", random_args["bitmodel_table_part"]),
                        ("bench", real["bitmodel_table_part"])] + list(more["bitmodel_table_part"].items()):
        emitted = bm.bitmodel_table_part(*args, emit_pack=True)
        equal_outputs(f"bitmodel emit_pack ({label})", emitted,
                      bm.bitmodel_table_part_plain(*args, emit_pack=True))
        equal_outputs(f"bitmodel table part, emit_pack on vs off ({label})", emitted[0],
                      bm.bitmodel_table_part(*args))
    errs["pack"] = 0.0
    cfg8 = Lc3Config.new(8000, FrameDuration.MS7P5)
    batches = {
        "bench 48k/10ms/150B": (cfg, NBYTES, pcm_in[tile, :2].transpose(1, 0, 2)),
        "noise 48k/10ms/150B": (cfg, NBYTES, noise_pcm(cfg, S_MAIN, 2, seed=4)),
        "mixed 48k/10ms/400B": (cfg, 400, mixed_pcm(cfg, S_MAIN, 2, seed=5)),
        "mixed 8k/7.5ms/40B": (cfg8, 40, mixed_pcm(cfg8, S_MAIN, 2, seed=6)),
    }
    packed, lines, frames_of = {}, [], {}
    for label, (c, nb, pcm_b) in batches.items():
        st = encoder_init(c, S_MAIN, dev)
        for f in range(pcm_b.shape[0]):
            st, fields = encode_step(c, nb, st, torch.as_tensor(pcm_b[f], device=dev),
                                     emit_pack=True)
        batches[label] = (c, nb, fields)
    # the ragged edge: the first 2,047 and the first stream of the 400 B batch
    c400, nb400, f400 = batches["mixed 48k/10ms/400B"]
    for n in (S_MAIN - 1, 1):
        batches[f"mixed 48k/10ms/400B S={n}"] = (c400, nb400, {
            k: (v[:, :n] if k == "quant_pack_tables" else v[:n]) if torch.is_tensor(v) else v
            for k, v in f400.items()})
    for label, (c, nb, fields) in batches.items():
        got = pack_kernel.device_pack(c, nb, fields)
        frames_of[label] = (c, nb, got)
        plain, stats = pack_kernel.device_pack_plain(c, nb, fields, stats=True)
        equal_outputs(f"pack ({label})", got, plain)
        host_fields = encoder_fields_to_numpy(
            {k: v for k, v in fields.items() if k != "quant_pack_tables"})
        host = host_pack.pack_frames(c, host_fields, nb)
        bad = np.flatnonzero((got.cpu().numpy() != host).any(1))
        if bad.size:
            raise AssertionError(f"pack ({label}): kernel != host packer, "
                                 f"streams {bad[:8].tolist()}")
        counts = {k: int(v.sum()) for k, v in stats.items()}
        packed[label] = (fields, host_fields, counts)
        lines.append(f"{label}: kernel = plain = host packer on {got.shape[0]} frames, {counts}")
    if packed["noise 48k/10ms/150B"][2]["lsb_mode"] == 0:
        raise AssertionError("pack: the noise batch has no frame in LSB mode")
    if not any(v[2]["carry"] for v in packed.values()):
        raise AssertionError("pack: no batch has a frame whose carry was resolved")
    torch.cuda.synchronize()
    log("pack-kernels", f"bitmodel emit_pack: equal (random and bench inputs, "
                        f"{', '.join(more['bitmodel_table_part'])}); " + "; ".join(lines))

    # ---- 4c. the parse kernel on the packed batches, every field
    lines, n_lsb = [], 0
    for label, (c, nb, frames_b) in frames_of.items():
        want = parse_equal(label, c, nb, frames_b)
        lsb_b = int(want.lsb_mode.sum())
        n_lsb += lsb_b
        lines.append(f"{label}: {frames_b.shape[0]} frames, {lsb_b} in LSB mode, "
                     f"{int(want.bad_frame.sum())} bad")
    if n_lsb == 0:
        raise AssertionError("parse: no LSB-mode frame was parsed")
    log("parse-kernels", f"kernel = plain on every field; {n_lsb} LSB-mode frames parsed; "
                         + "; ".join(lines))

    # ---- 5. the decode slice: BatchDecoder over T frames, S = 2048
    frames = bench["frames"]  # [4, T, nbytes], frame 5 of content 2 corrupt
    want = bench["pcm_out"][:, :T_FRAMES]
    dec = BatchDecoder(cfg, S_MAIN, NBYTES, device="cuda")
    _build.launches.clear()
    pcm = [dec.decode(frames[tile, f]) for f in range(T_FRAMES)]
    expect = step_launches("decode", n=T_FRAMES)
    launches = {k: launch_counts()[k] for k in expect}
    pcm = np.stack(pcm, 1)  # [S, T, nf]
    if launches != expect:
        raise AssertionError(f"decode launch counts {launches} != {expect}")
    if not all(np.array_equal(pcm[s], pcm[s % 4]) for s in range(S_MAIN)):
        raise AssertionError("streams with equal input decoded differently")
    # one envelope over the four distinct streams: alone, the quiet noise
    # stream (1500 rms) drops below 100 dB on a single 1-LSB flip in T frames
    per = [envelope(pcm[c], want[c]) for c in range(4)]
    lines = [check_envelope("contents 0-3", pcm[:4], want)] + [
        f"content {c}: max {m} LSB, {int((pcm[c] != want[c]).sum())} flips, {snr:.1f} dB"
        for c, (m, snr) in enumerate(per)]
    if dec.metrics.plc_frames != S_MAIN // 4:
        raise AssertionError(f"plc_frames {dec.metrics.plc_frames} != {S_MAIN // 4}")
    log("slice", f"S={S_MAIN} T={T_FRAMES}: launches {launches}; plc_rate "
                 f"{dec.metrics.plc_rate:.6f}; " + "; ".join(lines))

    # ---- 6. decode corpus and stream50 on the card
    runs = [(k, k.split("_"), corpus[k + "_pcm_in"], corpus[k + "_payloads"],
             corpus[k + "_pcm_out"]) for k in CORPUS]
    runs.append(("stream50", ["48000", "10ms"], s50["pcm_in"], s50["payloads"], s50["pcm_out"]))
    geo = lambda parts: Lc3Config.new(int(parts[0]), FrameDuration.MS7P5 if parts[1] == "7.5ms"
                                      else FrameDuration.MS10)
    lines = []
    for name, parts, _, pl, want_pcm in runs:
        d = BatchDecoder(geo(parts), 1, pl.shape[1], device="cuda")
        out = np.stack([d.decode(pl[f : f + 1])[0] for f in range(pl.shape[0])])
        lines.append(check_envelope(name, out, want_pcm))
    log("corpus", "; ".join(lines))

    # ---- 7. the encode slice: BatchEncoder over T frames, S = 2048
    enc = BatchEncoder(cfg, S_MAIN, NBYTES, device="cuda")
    _build.launches.clear()
    out = [enc.encode(pcm_in[tile, f]) for f in range(T_FRAMES)]
    expect = step_launches("fields", n=T_FRAMES)
    launches.update({k: launch_counts()[k] for k in expect})
    out = np.stack(out, 1)  # [S, T, nbytes]
    if any(launches[k] != n for k, n in expect.items()):
        raise AssertionError(f"encode launch counts { {k: launches[k] for k in expect} } "
                             f"!= {expect}")
    wrong = [s for s in range(S_MAIN) if not np.array_equal(out[s], bench["encoded"][s % 4, :T_FRAMES])]
    if wrong:
        f_bad = [int(np.flatnonzero((out[s] != bench["encoded"][s % 4, :T_FRAMES]).any(1))[0])
                 for s in wrong[:4]]
        raise AssertionError(f"encode: {len(wrong)}/{S_MAIN} streams differ from the oracle "
                             f"(streams {wrong[:4]}, first bad frames {f_bad})")
    log("encode", f"S={S_MAIN} T={T_FRAMES}: all {S_MAIN * T_FRAMES} frames equal the oracle's; "
                  f"launches { {k: launches[k] for k in expect} }; "
                  f"frames_encoded {enc.metrics.frames_encoded}")

    # ---- 7b. the fused encode slice: PCM to bytes on the card, S = 2048
    fenc = BatchEncoder(cfg, S_MAIN, NBYTES, device="cuda", device_pack=True)
    _build.launches.clear()
    out = [fenc.encode(pcm_in[tile, f]) for f in range(T_FRAMES)]
    want_fused = step_launches("bytes", n=T_FRAMES)
    counts = dict(launch_counts(), emit_pack=_build.launches[EMIT_PACK])
    fused = {k: counts[k] for k in want_fused}
    if fused != want_fused:
        raise AssertionError(f"fused encode launch counts {fused} != {want_fused}")
    launches["pack"] = fused["pack"]
    out = fused_out = np.stack(out, 1)  # [S, T, nbytes]
    wrong = [s for s in range(S_MAIN)
             if not np.array_equal(out[s], bench["encoded"][s % 4, :T_FRAMES])]
    if wrong:
        raise AssertionError(f"encode-fused: {len(wrong)}/{S_MAIN} streams differ from the oracle "
                             f"(streams {wrong[:4]})")
    log("encode-fused", f"S={S_MAIN} T={T_FRAMES}: all {S_MAIN * T_FRAMES} frames equal the "
                        f"oracle's; launches {fused}; frames_encoded {fenc.metrics.frames_encoded}")

    # ---- 8. encode corpus and stream50 on the card, S = 1
    lines = []
    for name, parts, pcm_c, pl, _ in runs:
        e = BatchEncoder(geo(parts), 1, pl.shape[1], device="cuda")
        got = np.stack([e.encode(pcm_c[f : f + 1])[0] for f in range(pcm_c.shape[0])])
        bad = np.flatnonzero((got != pl).any(1))
        if bad.size:
            raise AssertionError(f"encode-corpus {name}: {bad.size}/{len(pl)} frames differ "
                                 f"from the oracle's (first {bad[:8].tolist()})")
        lines.append(f"{name}: {len(pl)}/{len(pl)} equal")
    log("encode-corpus", "; ".join(lines))

    # ---- 8b. the same through the fused encode, S = 1
    lines = []
    for name, parts, pcm_c, pl, _ in runs:
        e = BatchEncoder(geo(parts), 1, pl.shape[1], device="cuda", device_pack=True)
        got = np.stack([e.encode(pcm_c[f : f + 1])[0] for f in range(pcm_c.shape[0])])
        bad = np.flatnonzero((got != pl).any(1))
        if bad.size:
            raise AssertionError(f"encode-fused-corpus {name}: {bad.size}/{len(pl)} frames differ "
                                 f"from the oracle's (first {bad[:8].tolist()})")
        lines.append(f"{name}: {len(pl)}/{len(pl)} equal")
    log("encode-fused-corpus", "; ".join(lines))

    # ---- 8c. the config-parity streams, the attack streams and the rate plan, S = 1
    cp = np.load(gold / "torch_config_parity.npz")
    lines = []
    for key in sorted(k[: -len("_pcm_in")] for k in cp.files if k.endswith("_pcm_in")):
        pcm_c, pl, want_pcm = cp[key + "_pcm_in"], cp[key + "_payloads"], cp[key + "_pcm_out"]
        if key == "rate_plan":
            c, plan = cfg, [int(n) for n in cp["rate_plan_nbytes"]]
        else:
            fs, ms, nb = key.split("_")[-3:]
            c, plan = geo([fs, ms]), [int(nb)] * len(pl)
        d = BatchDecoder(c, 1, plan[0], device="cuda")
        out = np.stack([d.decode(pl[f : f + 1, :nb])[0] for f, nb in enumerate(plan)])
        max_lsb, snr = envelope(out, want_pcm)
        if max_lsb > 1:
            raise AssertionError(f"config-parity {key}: decode max {max_lsb} LSB (need <= 1)")
        for fused_mode in (False, True):
            e = BatchEncoder(c, 1, plan[0], device="cuda", device_pack=fused_mode)
            bad = [f for f, nb in enumerate(plan)
                   if not np.array_equal(e.encode(pcm_c[f : f + 1], nbytes=nb)[0], pl[f, :nb])]
            if bad:
                raise AssertionError(f"config-parity {key} ({'fused' if fused_mode else 'host pack'}"
                                     f"): frames {bad[:8]} of {len(plan)} differ from the oracle's")
        lines.append(f"{key}: decode max {max_lsb} LSB ({snr:.1f} dB), {len(plan)}/{len(plan)} "
                     f"frames equal in both encode modes")
    log("config-parity", "; ".join(lines))

    # ---- 8d. serving: the parser fuzz, host-parse decode, decode_stream,
    # checkpoints, the CLI, and their times
    stream_rt = serving_phase(card, cfg, bench, corpus, cp, pcm)

    # ---- 9. times (CUDA events, median of REPS after warm-up)
    dec_ms = cuda_ms(lambda: dec.decode_tensor(pay))
    pcm0 = torch.as_tensor(pcm_in[tile, 0], device=dev)
    et = encode_times(enc, fenc, pcm_in[tile, 0], pcm0)
    enc_ms, enc_wall = float(np.median(et["dsp_event"])), float(np.median(et["enc_wall"]))
    fused_ms = float(np.median(et["fused_event"]))
    kargs = {
        "parse": ((cfg, NBYTES, pay), parse_kernel.parse_frames_cuda, cdev.device_parse_plain),
        "tns_synthesis": (real_tns, tns_kernel.tns_synthesis, tns_kernel.tns_synthesis_plain),
        "ltpf": (lt_args, ltpf_kernel.ltpf_both_passes, ltpf_kernel.ltpf_both_passes_plain),
    }
    for name, (kern, plain) in enc_fns.items():
        kargs[name] = (real[name], kern, plain)
    pack_f, pack_host_f, _ = packed["bench 48k/10ms/150B"]
    kargs["pack"] = ((cfg, NBYTES, pack_f), pack_kernel.device_pack, pack_kernel.device_pack_plain)
    plain_reps = {"pack": 5}  # a Python loop over about a thousand symbols
    times = {k: (cuda_ms(lambda: kern(*a)), cuda_ms(lambda: plain(*a), plain_reps.get(k, REPS)))
             for k, (a, kern, plain) in kargs.items()}
    bm_args = real["bitmodel_table_part"]
    emit = (cuda_ms(lambda: bitmodel_kernel.bitmodel_table_part(*bm_args, emit_pack=True)),
            cuda_ms(lambda: bitmodel_kernel.bitmodel_table_part_plain(*bm_args, emit_pack=True)))
    lt_main_fn = lambda: ltpf_kernel.ltpf_both_passes(*lt_main)
    lt_main_ms = [cuda_ms(lt_main_fn), None,
                  cuda_ms(lambda: ltpf_kernel.ltpf_both_passes_plain(*lt_main))]
    # the LTPF analysis at the benchmark cells' settings: 48 kHz / 10 ms /
    # 120 B on the bench content, 16 kHz / 10 ms / 40 B on mixed content,
    # against its plain version; here the event times, below the device's
    cfg16 = Lc3Config.new(16000, FrameDuration.MS10)
    lt_kern, lt_plain = enc_fns["ltpf_analysis"]
    lt_cells = {}
    for label, c, nb, x in (("48k/10ms/120B", cfg, 120, pcm_in[tile, 0]),
                            ("16k/10ms/40B", cfg16, 40, mixed_pcm(cfg16, S_MAIN, 1, 36)[0])):
        a = capture_kernel_inputs(c, torch.as_tensor(x, device=dev), nb)["ltpf_analysis"]
        equal_outputs(f"ltpf_analysis ({label})", lt_kern(*a), lt_plain(*a))
        lt_cells[label] = dict(args=a, ms=cuda_ms(lambda: lt_kern(*a)),
                               plain_ms=cuda_ms(lambda: lt_plain(*a)))
    # the gain estimate at the three encode cells' settings
    cfg48_1 = Lc3Config.new(48000, FrameDuration.MS7P5)
    gain_kern, gain_plain = enc_fns["gain_estimate"]
    gain_cells = {}
    for label, c, nb, x in (("48k/10ms/120B", cfg, 120, pcm_in[tile, 0]),
                            ("16k/10ms/40B", cfg16, 40, mixed_pcm(cfg16, S_MAIN, 1, 37)[0]),
                            ("48k/7.5ms/75B", cfg48_1, 75, mixed_pcm(cfg48_1, S_MAIN, 1, 38)[0])):
        a = capture_kernel_inputs(c, torch.as_tensor(x, device=dev), nb)["gain_estimate"]
        equal_outputs(f"gain_estimate ({label})", gain_kern(*a), gain_plain(*a))
        gain_cells[label] = dict(args=a, ms=cuda_ms(lambda: gain_kern(*a)),
                                 plain_ms=cuda_ms(lambda: gain_plain(*a)))
    # the SNS analysis' two kernels likewise
    sns_cells = {}
    for label, c, nb, x in (("48k/10ms/120B", cfg, 120, pcm_in[tile, 0]),
                            ("16k/10ms/40B", cfg16, 40, mixed_pcm(cfg16, S_MAIN, 1, 37)[0]),
                            ("48k/7.5ms/75B", cfg48_1, 75, mixed_pcm(cfg48_1, S_MAIN, 1, 38)[0])):
        seen = capture_kernel_inputs(c, torch.as_tensor(x, device=dev), nb)
        cell = sns_cells[label] = {}
        for name in ("sns_front", "sns_finish"):
            kern, plain = enc_fns[name]
            a = seen[name]
            equal_outputs(f"{name} ({label})", kern(*a), plain(*a))
            cell[name] = dict(args=a, ms=cuda_ms(lambda: kern(*a)),
                              plain_ms=cuda_ms(lambda: plain(*a)))
    host_ms = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        host_pack.pack_frames(cfg, pack_host_f, NBYTES)
        host_ms.append((time.perf_counter() - t0) * 1e3)

    # bounds, from this run's inputs; library calls where one computes the same
    bounds = {}
    p_out = cdev.device_parse_plain(cfg, NBYTES, pay)
    bounds["parse"] = bound(nbytes_of(pay, *[getattr(p_out, f.name)
                                             for f in dataclasses.fields(p_out)]), 0.0)
    xs, bw_s, ro_s, ri_s = real_tns[1:]
    # a lattice line of order k: 2k multiplies and 2k adds
    b4 = tab.tns_bounds[bw_s.long()].long()
    work = ((b4[:, 1] - b4[:, 0]) * 4 * ro_s[:, 0] + (b4[:, 3] - b4[:, 2]) * 4 * ro_s[:, 1])
    bounds["tns_synthesis"] = bound(2 * nbytes_of(xs) + nbytes_of(bw_s, ro_s, ri_s),
                                    float(work.sum()))
    # its chain floor: the fewest cycles a line that one stream alone takes
    # (those of the bench's four with a filter on, in an instrumented copy:
    # tools/kernel_phases.py),
    # times the most active lines a stream of the decode step runs, at the
    # card's highest SM clock
    chain_cyc = kernel_phases.synthesis_alone_cycles(real_tns)
    chain_lines = int(active_lines(tab, bw_s, ro_s, cfg.ne).max())
    clock = sm_clock_mhz()
    chain_floor = min(chain_cyc) * chain_lines / (clock * 1e3)
    # the SNS PVQ's: the fewest cycles a greedy round takes with one of the
    # bench's streams alone, times the most rounds a stream of the encoder's
    # bench arguments needs
    pvq_cyc, pvq_rounds = kernel_phases.pvq_alone_cycles(real["sns_pvq"][0])
    pvq_floor = min(pvq_cyc) * pvq_rounds / (clock * 1e3)
    # the LTPF reads only xcat[:, H - l_num:] and hist_y[:, H - rb:] (the
    # window tests/test_torch_ltpf.py pins), its other arguments whole, and
    # writes yA and yB
    _, xc_l, hy_l, *lt_rest, H_l, rb_l = lt_args
    bounds["ltpf"] = bound(nbytes_of(xc_l[:, H_l - tab.p.l_num:], hy_l[:, H_l - rb_l:], *lt_rest)
                           + 2 * nbytes_of(x_l),
                           2.0 * 2 * (tab.p.l_num + tab.p.l_den + 2) * x_l.numel())
    # PVQ: ~110 operations a greedy round over 16 lanes; the shape-3 rounds
    # this data needs, 2 for shape 2, at most 10 for shape 1; ~200 for the
    # projection and normalisations, 14 x 48 for the shape/gain search
    t2 = real["sns_pvq"][0]
    ax = t2.abs()
    k0 = torch.floor(ax * (5.0 / ax.sum(1, keepdim=True))).sum(1)
    rounds = (6 - k0).clamp(min=0) + 2 + 10
    bounds["sns_pvq"] = bound(nbytes_of(t2) + S_MAIN * (16 * 12 + 12),
                              float((110 * rounds + 200 + 14 * 48).sum()))
    # the TNS coefficients read x, bw_ind, near_nyquist and five small
    # tables, and write the lag sums and four fields; a multiply and an add
    # a term of the lag folds, and COEF_EPILOGUE_OPS a (stream, filter)
    ctab, xa, bwa, nna, _ = real["tns_coefficients"]
    suba = ctab.tns_sub[bwa.long()]
    lo, hi = suba[..., 0].long(), suba[..., 1].long()
    terms = sum(torch.clamp_min(hi - lo - k, 0).sum() for k in range(9))
    coef_out = S_MAIN * (54 + 16 + 16 + 2 + 1) * 4
    bounds["tns_coefficients"] = bound(
        nbytes_of(xa, bwa, nna, ctab.tns_sub, ctab.lag_window, ctab.tns_sin, ctab.tns_bits,
                  ctab.tns_step) + coef_out,
        2.0 * float(terms) + 2 * S_MAIN * COEF_EPILOGUE_OPS)
    # its chain floor: the fewest cycles the lag folds and the epilogue of
    # one (stream, filter) take alone (the bench's first four streams, the
    # filter whose chain is longer), at the card's highest SM clock
    coef_alone = kernel_phases.coefficient_chain(real["tns_coefficients"])
    coef_floor = min(a + b for a, b in coef_alone) / (clock * 1e3)
    xn, bnd, ro_e, nf_e, rcq = real["tns_analysis"]
    o2 = torch.stack([ro_e[:, 0], torch.where(nf_e > 1, ro_e[:, 1], 0)], 1).long()
    bl = bnd.reshape(-1, 4).long()
    work = ((bl[:, 1] - bl[:, 0]) * 4 * o2[:, 0] + (bl[:, 3] - bl[:, 2]) * 4 * o2[:, 1]).sum()
    bounds["tns_analysis"] = bound(2 * nbytes_of(xn) + nbytes_of(bnd, ro_e, nf_e, rcq),
                                   float(work))
    # the bit model reads c, g and sym of each stream's coded tuples only
    # (those below (lastnz + 1) >> 1), lastnz and its rate flag's precomposed
    # cost tables (bitmodel_kernel.compose_tables), and writes every tuple
    cb, gb, sb, _, _, lb = real["bitmodel_table_part"]
    coded = float(torch.clamp_max((lb.long() + 1) >> 1, cb.shape[1]).sum())
    per_tuple = cb.element_size() + gb.element_size() + sb.element_size()
    bm_bytes = coded * per_tuple + nbytes_of(lb) + bitmodel_kernel.ESC_OP * 4 + cb.numel() * 4
    bounds["bitmodel_table_part"] = bound(bm_bytes, 0.0)
    # with emit_pack it also reads the operand tables and writes 5 operands a tuple
    emit_bound = bound(bm_bytes + (bitmodel_kernel.TABLE_WORDS - bitmodel_kernel.ESC_OP) * 4
                       + 5 * cb.numel() * 4, 0.0)
    bounds["ltpf_analysis"] = ltpf_analysis_bound(real["ltpf_analysis"])
    bounds["gain_estimate"] = gain_bound(real["gain_estimate"])
    for name in ("sns_front", "sns_finish"):
        bounds[name] = sns_bound(name, real[name], enc_fns[name][1])
    # the pack kernel reads each stream's coded lines of x_q, the residual bit
    # of each line it may write, its 34 side fields and the operands of the
    # symbols it codes (each coded tuple's escapes and final), and writes
    # the frame
    xq_p = pack_f["x_q"]
    lnz_p = pack_f["quant_lastnz_trunc"].long()
    tup_p = tuple_symbols(xq_p)
    coded_p = torch.arange(cfg.ne // 2, device=dev)[None, :] < (lnz_p >> 1)[:, None]
    n_ops = float(torch.where(coded_p, tup_p["g"].long() + 1, 0).sum())
    n_res = float(torch.where(pack_f["quant_lsb_mode"], 0, pack_f["n_residual"].long()).sum())
    bounds["pack"] = bound(float(lnz_p.sum()) * xq_p.element_size() + n_res
                           + S_MAIN * pack_kernel.SIDE_ROWS * 4 + n_ops * 4
                           + pack_kernel.TABLE_WORDS * 4 + S_MAIN * NBYTES, 0.0)
    # TNS autocorrelation as one batched matmul of the masked windows against
    # their nine shifts (the yardstick; the port never calls it)
    Lw = int((hi - lo).max())
    pos = lo.reshape(S_MAIN, 6, 1) + torch.arange(Lw + 8, device=dev)
    xw = xa.gather(1, pos.clamp(max=cfg.ne - 1).reshape(S_MAIN, -1)).reshape(S_MAIN * 6, Lw + 8)
    xw = torch.where(pos.reshape(S_MAIN * 6, -1) < hi.reshape(-1, 1), xw, 0.0)
    lagged = xw.unfold(1, Lw, 1)[:, :9].transpose(1, 2).contiguous()  # [S*6, Lw, 9]
    head = xw[:, None, :Lw].contiguous()
    library = {k: None for k in times}
    bmm = lambda: torch.bmm(head, lagged)
    # the kernel and the library call alternated call by call over PAIR_REPS
    # calls each (the host sets both event times, and moves), then each
    # one's device time
    coef_fn = lambda: tns_enc_kernel.tns_coefficients(*real["tns_coefficients"])
    ac_ms, library["tns_coefficients"] = cuda_ms_pair(coef_fn, bmm, PAIR_REPS)
    times["tns_coefficients"] = (ac_ms, times["tns_coefficients"][1])
    # each kernel's device time apart from its wrapper's host work, after
    # every event time so that no profiler session precedes one
    dev_ms = {k: device_ms(lambda: kern(*a), KERNELS[k][1]) for k, (a, kern, _) in kargs.items()}
    emit_dev = device_ms(lambda: bitmodel_kernel.bitmodel_table_part(*bm_args, emit_pack=True),
                         "bitmodel_kernel")
    lt_main_ms[1] = device_ms(lt_main_fn, "ltpf_kernel")
    library_dev = {"tns_coefficients": device_ms(bmm, None)}
    # the LTPF analysis: one stream alone is its chain's time on the card
    lt_one = ltpf_first_stream(real["ltpf_analysis"])
    lt_alone = device_ms(lambda: lt_kern(*lt_one), "ltpf_analysis_kernel")
    for label, cell in lt_cells.items():
        a = cell.pop("args")
        one = ltpf_first_stream(a)
        cell.update(device_ms=device_ms(lambda: lt_kern(*a), "ltpf_analysis_kernel"),
                    one_stream_device_ms=device_ms(lambda: lt_kern(*one), "ltpf_analysis_kernel"))
        cell["bound_ms"], cell["bound_by"] = ltpf_analysis_bound(a)
    # the gain estimate: one stream alone is its chain's time on the card
    for label, cell in gain_cells.items():
        a = cell.pop("args")
        one = (a[0][:1], a[1][:1], *a[2:])
        cell.update(device_ms=device_ms(lambda: gain_kern(*a), "gain_estimate_kernel"),
                    one_stream_device_ms=device_ms(lambda: gain_kern(*one), "gain_estimate_kernel"))
        cell["bound_ms"], cell["bound_by"] = gain_bound(a)
    # the SNS analysis: one stream alone is its chain's time on the card
    for label, cell in sns_cells.items():
        for name, c in cell.items():
            kern, plain = enc_fns[name]
            a = c.pop("args")
            one = tuple(t[:1] if torch.is_tensor(t) else t for t in a)
            glob = KERNELS[name][1]
            c.update(device_ms=device_ms(lambda: kern(*a), glob),
                     one_stream_device_ms=device_ms(lambda: kern(*one), glob))
            c["bound_ms"], c["bound_by"] = sns_bound(name, a, plain)

    rt = lambda ms: S_MAIN * (cfg.nf / cfg.fs) / (ms / 1e3)
    log("encode-times", f"{card}, S={S_MAIN}, {REPS} reps alternated, median [min-max] ms: "
                        + encode_times_line(et))
    log("times", f"{card}: decode step {dec_ms:.4f} ms = {rt(dec_ms):.1f}x realtime; "
                 f"encode DSP step {enc_ms:.4f} ms = {rt(enc_ms):.1f}x realtime; "
                 f"encode with host pack {enc_wall:.4f} ms wall = {rt(enc_wall):.1f}x realtime; "
                 f"fused encode step {fused_ms:.4f} ms = {rt(fused_ms):.1f}x realtime "
                 f"(S={S_MAIN}, 48k/10ms/150B); "
                 f"bitmodel_table_part with emit_pack kernel {emit[0]:.4f} ms (device "
                 f"{emit_dev:.4f}) vs plain {emit[1]:.4f} ms, bound {emit_bound[0]:.5f} ms "
                 f"({emit_bound[1]}); ltpf on the decode step's arguments kernel "
                 f"{lt_main_ms[0]:.4f} ms (device {lt_main_ms[1]:.4f}) vs plain "
                 f"{lt_main_ms[2]:.4f} ms; " + "; ".join(
                     f"{k} kernel {a:.4f} ms (device {dev_ms[k]:.4f}) vs plain {b:.4f} ms, "
                     f"bound {bounds[k][0]:.5f} ms ({bounds[k][1]})"
                     + (f", library {library[k]:.4f} ms (device {library_dev[k]:.4f})"
                        if library[k] is not None else "")
                     for k, (a, b) in times.items()))
    log("tns-chain", f"{card}: tns_synthesis one stream alone "
                     f"{', '.join(f'{c:.1f}' for c in chain_cyc)} cycles a line (those of the "
                     f"bench's four streams with a filter on); x {chain_lines} active lines at "
                     f"{clock:.0f} MHz = chain floor "
                     f"{chain_floor:.5f} ms against {dev_ms['tns_synthesis']:.4f} ms on the device")
    log("pvq-chain", f"{card}: sns_pvq one stream alone "
                     f"{', '.join(f'{c:.1f}' for c in pvq_cyc)} cycles a greedy round (the "
                     f"bench's four streams); x {pvq_rounds} rounds at {clock:.0f} MHz = chain floor "
                     f"{pvq_floor:.5f} ms against {dev_ms['sns_pvq']:.4f} ms on the device")
    log("tns-coef", f"{card}: tns_coefficients kernel {times['tns_coefficients'][0]:.4f} ms "
                    f"(device {dev_ms['tns_coefficients']:.4f}); one (stream, filter) alone, "
                    f"(lag folds, epilogue) cycles "
                    f"{coef_alone} (the bench's four streams) at {clock:.0f} MHz = chain floor "
                    f"{coef_floor:.5f} ms; bound {bounds['tns_coefficients'][0]:.5f} ms "
                    f"({bounds['tns_coefficients'][1]})")
    log("ltpf-analysis", f"{card}, S={S_MAIN}: " + "; ".join(
        f"{label}: kernel {c['ms']:.4f} ms (device {c['device_ms']:.4f}, one stream alone "
        f"{c['one_stream_device_ms']:.4f}) vs plain {c['plain_ms']:.4f} ms, bound "
        f"{c['bound_ms']:.5f} ms ({c['bound_by']})" for label, c in lt_cells.items())
        + f"; 48k/10ms/150B one stream alone {lt_alone:.4f} ms on the device")
    log("gain-estimate", f"{card}, S={S_MAIN}: " + "; ".join(
        f"{label}: kernel {c['ms']:.4f} ms (device {c['device_ms']:.4f}, one stream alone "
        f"{c['one_stream_device_ms']:.4f}) vs plain {c['plain_ms']:.4f} ms, bound "
        f"{c['bound_ms']:.5f} ms ({c['bound_by']})" for label, c in gain_cells.items()))
    log("sns-analysis", f"{card}, S={S_MAIN}: " + "; ".join(
        f"{label}: " + ", ".join(
            f"{name} kernel {c['ms']:.4f} ms (device {c['device_ms']:.4f}, one stream alone "
            f"{c['one_stream_device_ms']:.4f}) vs plain {c['plain_ms']:.4f} ms, bound "
            f"{c['bound_ms']:.5f} ms ({c['bound_by']})" for name, c in cell.items())
        + f"; both on the device {sum(c['device_ms'] for c in cell.values()):.4f} ms, one "
          f"stream alone {sum(c['one_stream_device_ms'] for c in cell.values()):.4f} ms"
        for label, cell in sns_cells.items()))
    log("host-pack", f"{card}: the C++ host packer (native/lc3_bitstream.cc, {host_pack.N_THREADS} "
                     f"threads) on the pack kernel's bench fields, S={S_MAIN}, 150 B: "
                     f"{spread(host_ms)} ms wall, median [min-max] of {REPS}")

    # ---- 10. sharding over the mesh and processes, and the profiling hooks
    sharding_phase(card, cfg, bench, pcm, fused_out, stream_rt)

    # ---- 11. compiled steps against the eager steps, counts, times
    compiled_phase(card, cfg, bench)

    # ---- 12. the reference-parity facade, the calculators and short frames
    api_phase(card, cfg, s50)
    log("done", f"{time.perf_counter() - t_start:.1f} s")

    names = {"ltpf": "ltpf_both_passes"}
    kernels = [
        {"name": names.get(k, k), "route": "cuda", "source": "lc3jax_torch/csrc/" + f,
         "replaces": r,
         "launches": launches[k], "max_abs_err": errs.get(k), "ms": times[k][0],
         "plain_ms": times[k][1], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": library[k], "device_ms": dev_ms[k]}
        for k, (_, _, f, r) in KERNELS.items()
    ]
    kernels[list(KERNELS).index("bitmodel_table_part")].update(
        emit_pack_launches=fused["emit_pack"], emit_pack_ms=emit[0],
        emit_pack_device_ms=emit_dev, emit_pack_plain_ms=emit[1],
        emit_pack_bound_ms=emit_bound[0])
    kernels[list(KERNELS).index("ltpf")].update(
        decode_step_args_ms=lt_main_ms[0], decode_step_args_device_ms=lt_main_ms[1],
        decode_step_args_plain_ms=lt_main_ms[2])
    kernels[list(KERNELS).index("tns_coefficients")].update(
        library_device_ms=library_dev["tns_coefficients"], library_covers="the lag sums only",
        chain_floor_ms=coef_floor, chain_cycles=min(a + b for a, b in coef_alone),
        chain_cycles_alone=coef_alone, sm_clock_mhz=clock)
    kernels[list(KERNELS).index("ltpf_analysis")].update(
        one_stream_device_ms=lt_alone, cells=lt_cells)
    kernels[list(KERNELS).index("gain_estimate")].update(cells=gain_cells)
    for name in ("sns_front", "sns_finish"):
        kernels[list(KERNELS).index(name)].update(
            cells={label: cell[name] for label, cell in sns_cells.items()})
    kernels[list(KERNELS).index("tns_synthesis")].update(
        chain_floor_ms=chain_floor, chain_cycles_a_line=min(chain_cyc), chain_lines=chain_lines,
        sm_clock_mhz=clock)
    kernels[list(KERNELS).index("sns_pvq")].update(
        chain_floor_ms=pvq_floor, chain_cycles_a_round=min(pvq_cyc), chain_rounds=pvq_rounds,
        sm_clock_mhz=clock)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-worker"]:
        sys.exit(shard_worker(*sys.argv[2:]))
    sys.exit(main())
