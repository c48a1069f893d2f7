#!/usr/bin/env python3
"""Cycles per phase of the port's kernels on a CUDA card: the range coders
(parse, pack), the two TNS lattices, the SNS PVQ search, the bit model or
the TNS coefficient kernel; and the chain floors chip_smoke.py reads.

    python3 tools/kernel_phases.py [--kernels range|tns|sns|bitmodel|coefficients]

Each mode copies its kernels' sources from lc3jax_torch/csrc into a
temporary directory, stamps `clock64()` at their phase boundaries and counts
the steps of each stream's chain, builds them with the port's nvcc flags and
runs them on chip_smoke.py's inputs at S = 2048 (48 kHz / 10 ms / 150 B
unless stated), every instrumented kernel's outputs checked equal to its
plain version. Then the bench content's first four streams run one at a
time (S = 1, alone on the card): the chain phase's cycles over its steps is
the chain's own latency a step.

Range coders (the default; a warp a stream): the bench content (its first
stored frame for parse, its fields for pack), full-scale noise at 150 B
(every frame in LSB mode) and mixed content at 400 B; alone, the spectral
phase's cycles a symbol.

TNS (`--kernels tns`): the analysis lattice on the arguments the encoder
gives it for the bench content, the synthesis lattice on those the decode
step gives it; stamps per stream (per warp's lane 0 for the analysis): the
staging, the walk or chain, the wait for the block and the store; alone,
cycles a line (for the analysis, over the lines lane 0 walks).
`synthesis_alone_cycles` gives chip_smoke.py the synthesis chain's for its
floor.

SNS PVQ (`--kernels sns`; a greedy warp, a lane a stream, and 16 search
lanes a stream): on the encoder's bench arguments, the cycles of each phase
per stream (load and projection, shapes 3, 2 and 1, what follows the
rounds) and the greedy rounds it needed; alone, cycles a round.
`pvq_alone_cycles` gives chip_smoke.py those for its chain floor.

Bit model (`--kernels bitmodel`): on the encoder's bench arguments, with and
without emit_pack, the cycles of each block staging its tables, on its
tuples, and (with emit_pack) from the wait for the transposed operand rows
to their last store.

TNS coefficients (`--kernels coefficients`): on the encoder's bench
arguments, the cycles of the staging, lag folds and epilogue of each
(stream, filter); alone, the lag folds' and the epilogue's
(`coefficient_chain` gives chip_smoke.py those for its chain floor); the
kernel's event and device ms. Its copy writes the unquantised reflection
coefficients where rc_q goes and holds them equal to
`tns_enc_kernel.tns_lpc_plain`, op for op.

Each mode prints `-Xptxas -v` of its kernels and ends with one JSON line.
Needs a card; the instrumented copies are never written into the repo. The
edits are anchored on the sources' text: a change to a kernel may need its
anchors updated.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
S = 2048
_P, _I = ctypes.c_void_p, ctypes.c_int

# Edits of each source: (anchor that occurs once, text, where: "after" or
# "before" the anchor, "after_line" its first line, or "replace" it). Each
# kernel gets a `long long* stamps` parameter, keeps its n stamps in st_[]
# and its count of spectral symbols in n_, and stores them as
# stamps[s * (n + 1) + k], the count last.
PARSE = (
    [("int fs_ind, int is_7p5) {\n  extern __shared__", "int fs_ind, int is_7p5, long long* __restrict__ stamps) {\n"
      "  extern __shared__", "replace"),
     ("  const int u = tid >> 5;  // this warp's stream in the block\n",
      "  long long st_[8] = {0};\n  int n_ = 0;\n  st_[0] = clock64();\n", "after"),
     ("  if (u < nvalid) {\n    int* x = xs + u * ne;", "  st_[1] = clock64();\n", "before"),
     ("      // ---------------- spectral tuples (arithmetic_codec.rs:211-305)\n", "      st_[2] = clock64();\n", "before"),
     ("          sym = f.decode<17>(spec + 16 * tab[kLookup + li]);\n", "          ++n_;\n", "after"),
     ("      // ---------------- the residual budget", "      st_[3] = clock64();\n", "before"),
     ("    // lane 0 alone from here to the rows", "    st_[4] = clock64();\n", "before"),
     ("    // ---------------- the noise-filling seed", "    st_[5] = clock64();\n", "before"),
     ("  __syncthreads();\n\n  // ---------------- the block's rows out", "  st_[6] = clock64();\n", "before"),
     ("    if (k < nvalid) rows8[(size_t)r * S + s0 + k] = s_rows8[r][k];\n  }\n",
      "  __syncthreads();\n  st_[7] = clock64();\n  if (lane == 0 && u < nvalid) {\n"
      "    for (int k_ = 0; k_ < 8; ++k_) stamps[(size_t)(s0 + u) * 9 + k_] = st_[k_];\n"
      "    stamps[(size_t)(s0 + u) * 9 + 8] = n_;\n  }\n", "after"),
     ("                          void* stream) {", "                          void* stream, long long* stamps) {", "replace"),
     ("payloads, tables, pool32, pool8, S, nbytes, ne, fs_ind, is_7p5);",
      "payloads, tables, pool32, pool8, S, nbytes, ne, fs_ind, is_7p5, stamps);", "replace")],
    ("stage", "side info, TNS symbols", "spectral tuples", "budget, residual bits (warp)",
     "LSB refinement, MPVQ, fields", "seed (warp)", "block copy-out"))
PACK = (
    [
        ("  w.uint_backward(field(kNoiseFactor), 3);\n", "  st_[2] = clock64();\n", "after"),
        ("      st.encode(w, v & 1023, uint32_t(v) >> 10);\n      if (!(lsb_mode", "      ++n_;\n", "after_line"),
        ("    st.encode(w, v & 1023, uint32_t(v) >> 10);\n    const bool halve", "    ++n_;\n", "after_line"),
        ("  st.finish(w);\n  w.final_flush();\n", "  st_[5] = clock64();\n", "before"),
        ("int nbits_bw, int lpcw) {\n  const int NT = ne / 2;\n  auto field",
         "int nbits_bw, int lpcw, long long* st_, int& n_) {\n  const int NT = ne / 2;\n  auto field", "replace"),
        ("  // ---- spectral tuples (lc3_bitstream.cc:1006-1047)", "  st_[3] = clock64();\n", "before"),
        ("  // ---- residual or LSB bits in the gap", "  st_[4] = clock64();\n", "before"),
        ("  st.finish(w);\n  w.final_flush();\n", "  st_[6] = clock64();\n", "after"),
        ("int S, int ne, int nbytes, int nbits_bw, int lpcw) {\n  extern",
         "int S, int ne, int nbytes, int nbits_bw, int lpcw, long long* __restrict__ stamps) {\n  extern",
         "replace"),
        ("  const int tid = threadIdx.x;\n\n", "  long long st_[8] = {0};\n  int n_ = 0;\n  st_[0] = clock64();\n",
         "after"),
        ("  // lane 0 of warp u codes stream s0 + u\n", "  st_[1] = clock64();\n", "before"),
        ("               ne, nbytes, nbits_bw, lpcw);", "               ne, nbytes, nbits_bw, lpcw, st_, n_);", "replace"),
        ("  block_copy(out + (size_t)s0 * nbytes, rows, nvalid * nbytes);\n",
         "  __syncthreads();\n  st_[7] = clock64();\n  if ((tid & 31) == 0 && u < nvalid) {\n"
         "    for (int k_ = 0; k_ < 8; ++k_) stamps[(size_t)(s0 + u) * 9 + k_] = st_[k_];\n"
         "    stamps[(size_t)(s0 + u) * 9 + 8] = n_;\n  }\n", "after"),
        ("int nbits_bw, int lpcw, void* stream) {", "int nbits_bw, int lpcw, void* stream, long long* stamps) {",
         "replace"),
        ("xq, res, side, pk, tab, out, S, ne, nbytes, nbits_bw, lpcw);",
         "xq, res, side, pk, tab, out, S, ne, nbytes, nbits_bw, lpcw, stamps);", "replace")],
    ("stage", "side info", "TNS symbols", "spectral tuples", "residual/LSB fill", "finish",
     "block copy-out"))


# The TNS lattices stamp staging, walk or chain, the block's wait and the
# store, per stream (the analysis: lane 0 of the stream's warp, and the
# lines it walks). Stamps are stored as stamps[s * (n + 1) + k], the line
# count last.
_STORE_TNS = ("  __syncthreads();\n  st_[4] = clock64();\n  if ({who}) {{\n"
              "    for (int k_ = 0; k_ < 5; ++k_) stamps[(size_t)({s}) * 6 + k_] = st_[k_];\n"
              "    stamps[(size_t)({s}) * 6 + 5] = n_;\n  }}\n")
TNS = {
    "tns_synthesis": (
        [("float* __restrict__ y, int S, int ne, int row) {",
          "float* __restrict__ y, int S, int ne, int row, long long* __restrict__ stamps) {", "replace"),
         ("  const int tid = threadIdx.x;\n", "  long long st_[5] = {0};\n  int n_ = 0;\n  st_[0] = clock64();\n",
          "after"),
         ("  __syncthreads();\n\n  if (tid < nvalid) {", "  st_[1] = clock64();\n", "after_line"),
         ("      lattice(row_s, n, end, rc, st);\n", "      n_ += end - n;\n", "after"),
         ("      n = end;\n    }\n  }\n  __syncthreads();\n",
          "      n = end;\n    }\n    st_[2] = clock64();\n  }\n  __syncthreads();\n  st_[3] = clock64();\n",
          "replace"),
         ("  lc3t::store_rows<kThreads>(y + (size_t)s0 * ne, xs, row, ne, nvalid);\n",
          _STORE_TNS.format(who="tid < nvalid", s="s0 + tid"), "after"),
         ("float* y, int S, int ne, void* stream) {",
          "float* y, int S, int ne, void* stream, long long* stamps) {", "replace"),
         ("tns_sin, y, S, ne, row);", "tns_sin, y, S, ne, row, stamps);", "replace")],
        ("stage", "chain", "wait for the block", "store")),
    "tns_analysis": (
        [("float* __restrict__ y, int S, int ne,\n                    int row) {",
          "float* __restrict__ y, int S, int ne,\n                    int row, long long* __restrict__ stamps) {",
          "replace"),
         ("  const int tid = threadIdx.x;\n", "  long long st_[5] = {0};\n  int n_ = 0;\n  st_[0] = clock64();\n",
          "after"),
         ("// lines outside the filters\n  __syncthreads();\n", "  st_[1] = clock64();\n", "after"),
         ("          }\n        }\n        rank += len[j];\n",
          "          }\n          n_ += b - a;\n        }\n        rank += len[j];\n", "replace"),
         ("        rank += len[j];\n      }\n    }\n  }\n  __syncthreads();\n",
          "        rank += len[j];\n      }\n    }\n    st_[2] = clock64();\n  }\n  __syncthreads();\n"
          "  st_[3] = clock64();\n", "replace"),
         ("  lc3t::store_rows<kThreads>(y + (size_t)s0 * ne, ys, row, ne, nvalid);\n",
          _STORE_TNS.format(who="lane == 0 && u < nvalid", s="s0 + u"), "after"),
         ("float* y, int S,\n                                 int ne, void* stream) {",
          "float* y, int S,\n                                 int ne, void* stream, long long* stamps) {", "replace"),
         ("rc_q, y, S, ne, row);", "rc_q, y, S, ne, row, stamps);", "replace")],
        ("stage", "lane 0's walk", "wait for the block", "store")),
}
TNS_ARGTYPES = {"tns_synthesis": [_P] * 7 + [_I] * 2 + [_P, _P],
                "tns_analysis": [_P] * 6 + [_I] * 2 + [_P, _P]}


# The SNS PVQ search. Stamps per stream and the greedy rounds the stream
# needed, last: stamps[s * (n + 1) + k]. The greedy warp's lane for the
# stream stores the stamps up to the rounds' end and the count, and the
# stream's lane 0 of the search the last two (the same SM's clock).
_PVQ_ENTRY = [
    ("const float* __restrict__ gains, int S) {",
     "const float* __restrict__ gains, int S, long long* __restrict__ stamps) {", "replace"),
    ("int S, void* stream) {", "int S, void* stream, long long* stamps) {", "replace"),
    ("gains, S);", "gains, S, stamps);", "replace")]
PVQ = (_PVQ_ENTRY + [
    ("  const int tid = threadIdx.x;\n", "  long long st_[7];\n  int n_ = 0;\n  st_[0] = clock64();\n",
     "after"),
    ("    // shape 3: K = 6", "    st_[1] = clock64();\n", "before"),
    ("count < 6; ++r, ++count) greedy<16>(ty, ax, a);",
     "count < 6; ++r, ++count) {\n      greedy<16>(ty, ax, a);\n      ++n_;\n    }", "replace"),
    ("    // shape 2: two more", "    st_[2] = clock64();\n", "before"),
    ("for (int r = 0; r < 2; ++r) greedy<16>(ty, ax, a);",
     "for (int r = 0; r < 2; ++r) {\n      greedy<16>(ty, ax, a);\n      ++n_;\n    }", "replace"),
    ("    // shape 1: strip set B", "    st_[3] = clock64();\n", "before"),
    ("count < 10; ++r, ++count) greedy<10>(ty, ax, a);\n",
     "count < 10; ++r, ++count) {\n      greedy<10>(ty, ax, a);\n      ++n_;\n    }\n"
     "    st_[4] = clock64();\n", "replace"),
    ("      s_nb[u] = nb;\n",
     "      for (int k_ = 0; k_ < 5; ++k_) stamps[(size_t)(s0 + u) * 8 + k_] = st_[k_];\n"
     "      stamps[(size_t)(s0 + u) * 8 + 7] = n_;\n", "after"),
    ("  if (!valid) return;\n", "  st_[5] = clock64();\n", "before"),
    ("    g_sel_out[s] = g_sel;\n  }\n",
     "  __threadfence_block();\n  st_[6] = clock64();\n  if (k == 0) {\n"
     "    stamps[(size_t)s * 8 + 5] = st_[5];\n    stamps[(size_t)s * 8 + 6] = st_[6];\n  }\n", "after")],
    ("load, projection", "shape 3", "shape 2", "shape 1",
     "set B, barrier, shapes 1 and 0 normalised, search", "stores"))
PVQ_GREEDY = (1, 4)  # the stamps around shapes 3, 2 and 1

# The bit model. Every thread stores its start, its end of staging, its end
# and (with emit_pack) the cycles from the block's wait for the transposed
# operand rows to its end of storing them:
# stamps[(block * 256 + thread) * 4 + k].
BM_THREADS = 256
BM = [
    ("int S, int NT, int ne4) {\n  __shared__",
     "int S, int NT, int ne4, long long* __restrict__ stamps) {\n  __shared__", "replace"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const long long t0_ = clock64();\n  long long rows_ = 0;\n", "after"),
    ("  if (tid < kS) s_lim[tid] = s0 + tid < S ? (lastnz[s0 + tid] + 1) >> 1 : 0;\n  __syncthreads();\n",
     "  const long long t1_ = clock64();\n", "after"),
    ("  if (kEmit) {\n    __syncthreads();\n",
     "  if (kEmit) {\n    const long long r0_ = clock64();\n    __syncthreads();\n", "replace"),
    ("s_rows[k * (kS + 1) + lane];\n    }\n  }\n}\n",
     "s_rows[k * (kS + 1) + lane];\n    }\n    rows_ = clock64() - r0_;\n  }\n"
     "  long long* sp_ = stamps + ((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * kThreads + tid) * 4;\n"
     "  sp_[0] = t0_;\n  sp_[1] = t1_;\n  sp_[2] = clock64();\n  sp_[3] = rows_;\n}\n", "replace"),
    ("int ne4,\n                             void* stream) {",
     "int ne4,\n                             void* stream, long long* stamps) {", "replace"),
    ("pk, S, NT, ne4);", "pk, S, NT, ne4, stamps);", "replace_all")]
BM_PHASES = ("stage", "tuples", "operand rows")

# The TNS coefficient kernel. Its copy stamps, per (stream, filter) warp,
# its start, the end of the staging, of the lag folds (after a __syncwarp,
# so the warp's longest fold) and of the epilogue, as
# stamps[(s * 2 + f) * 4 + k], and writes the unquantised reflection
# coefficient where rc_q goes, so that the recursion is held op for op
# against tns_lpc_plain.
COEF_PHASES = ("stage", "lag folds", "epilogue")
COEF = [
    ("int row, int lpc_weighting) {", "int row, int lpc_weighting, long long* __restrict__ stamps) {",
     "replace"),
    ("  __shared__ int s_bits[kStreams][2];\n", "  long long st_[4] = {0};\n  st_[0] = clock64();\n",
     "after"),
    ("  lc3t::wait_async_copies();\n  __syncthreads();\n", "  st_[1] = clock64();\n", "after"),
    ("    if (lane < 27) ac[(size_t)s * 54 + f * 27 + lane] = acc;\n",
     "    __syncwarp();\n    st_[2] = clock64();\n", "after"),
    ("      s_bits[u][f] = exists ? add : 0;\n    }\n",
     "    st_[3] = clock64();\n    if (lane == 0)\n      for (int k_ = 0; k_ < 4; ++k_) "
     "stamps[((size_t)s * 2 + f) * 4 + k_] = st_[k_];\n", "after"),
    ("exists ? tns_sin[ric] : 0.0f", "exists ? mine : 0.0f", "replace"),
    ("int ne, int lpc_weighting, void* stream) {",
     "int ne, int lpc_weighting, void* stream, long long* stamps) {", "replace"),
    ("rc_order, nbits_tns, S, ne, row, lpc_weighting);",
     "rc_order, nbits_tns, S, ne, row, lpc_weighting, stamps);", "replace"),
]


def instrument(text: str, edits, entry: str) -> str:
    """Apply the edits (each anchor must occur once) and rename the C entry
    `entry` to `entry`_phase."""
    for anchor, add, where in edits:
        if text.count(anchor) != 1 and not (where == "replace_all" and anchor in text):
            raise ValueError(f"anchor not found once: {anchor!r}")
        if where == "after":
            new = anchor + add
        elif where == "before":
            new = add + anchor
        elif where == "after_line":  # after the anchor's first line
            first, rest = anchor.split("\n", 1)
            new = first + "\n" + add + rest
        else:  # replace, replace_all
            new = add
        text = text.replace(anchor, new)
    old = f'extern "C" int {entry}('
    if text.count(old) != 1:
        raise ValueError(f"entry {entry} not found once")
    return text.replace(old, f'extern "C" int {entry}_phase(')


def build_one(nvcc: str, kern: str, edits, argtypes):
    """The C entry lc3t_<kern>_phase of the instrumented csrc/<kern>.cu,
    built with the port's nvcc flags in a temporary directory."""
    from lc3jax_torch import _build

    tmp = Path(tempfile.mkdtemp())
    f = tmp / f"{kern}.cu"
    f.write_text(instrument((_build.CSRC / f"{kern}.cu").read_text(), edits, f"lc3t_{kern}"))
    so = tmp / f"lib{kern}_phase.so"
    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(so),
                        str(f)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"kernel_phases: nvcc failed on {kern}:\n{r.stderr}")
    fn = getattr(ctypes.CDLL(str(so)), f"lc3t_{kern}_phase")
    fn.argtypes = argtypes
    return fn


def ptxas_lines(nvcc: str, kern: str) -> list:
    """`-Xptxas -v`'s registers, spills and stack frame of each kernel of
    csrc/<kern>.cu."""
    from lc3jax_torch import _build

    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", "/dev/null",
                        str(_build.CSRC / f"{kern}.cu")], capture_output=True, text=True)
    lines = [ln.split(":", 1)[-1].strip() for ln in r.stderr.splitlines()
             if "registers" in ln or "stack frame" in ln or "Compiling entry" in ln]
    print(f"ptxas {kern}: {lines}", flush=True)
    return lines


def summarize(st: np.ndarray, names, count: str = "count") -> dict:
    """Median and max over streams of each phase's cycles, the total and the
    count stored last."""
    n = len(names) + 1
    d = np.diff(st[:, :n].astype(np.int64), axis=1)
    out = {k: [float(np.median(d[:, i])), int(d[:, i].max())] for i, k in enumerate(names)}
    tot = st[:, n - 1] - st[:, 0]
    out["total"] = [float(np.median(tot)), int(tot.max())]
    out[count] = [float(np.median(st[:, n])), int(st[:, n].max())]
    return out


def sm_clocks() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def bench_encoder_args() -> dict:
    """The arguments the encoder gives each of its kernels for chip_smoke.py's
    bench content (its first frame, the four contents tiled over S streams)."""
    import torch

    import chip_smoke as cs
    from lc3jax_torch.config import FrameDuration, Lc3Config

    bench = np.load(ROOT / "tests" / "goldens" / "torch_bench_content.npz")
    pcm = torch.as_tensor(bench["pcm_in"][np.arange(S) % 4, 0], device="cuda")
    return cs.capture_kernel_inputs(Lc3Config.new(48000, FrameDuration.MS10), pcm)


def run_tns(fn, kern: str, args) -> "np.ndarray":
    """One launch of the instrumented `kern` on the wrapper's arguments
    `args` (tns_synthesis: tab, x, bandwidth, rc_order, rc_i; tns_analysis:
    x, bounds, rc_order, num_filters, rc_q); checks the output equal to the
    plain version and returns the stamps [S, phases + 2]."""
    import torch

    from lc3jax_torch.dsp import tns_enc_kernel, tns_kernel

    if kern == "tns_synthesis":
        tab, x, bw, ro, ri = args
        plain = tns_kernel.tns_synthesis_plain(*args)
        ops = [bw, ro, ri, tab.tns_bounds, tab.tns_sin]
    else:
        x, bnd, ro, nf, rcq = args
        plain = tns_enc_kernel.tns_analysis_plain(*args)
        ops = [bnd, ro, nf, rcq]
    S, ne = x.shape
    stamps = torch.zeros(S, len(TNS[kern][1]) + 2, dtype=torch.int64, device=x.device)
    out = torch.empty_like(x)
    err = fn(x.contiguous().data_ptr(), *[t.contiguous().data_ptr() for t in ops], out.data_ptr(),
             S, ne, torch.cuda.current_stream().cuda_stream, stamps.data_ptr())
    if err:
        raise RuntimeError(f"{kern}_phase: CUDA error {err}")
    torch.cuda.synchronize()
    if not torch.equal(out, plain):
        raise AssertionError(f"instrumented {kern} != plain")
    return stamps.cpu().numpy()


def alone_cycles(fn, kern: str, args, streams=range(4)) -> list:
    """Cycles a line of the chain phase (the synthesis' chain or the
    analysis' lane 0 walk) with each of `streams` that has an active line
    alone on the card (S = 1)."""
    per = []
    for s in streams:
        one = tuple(a[s : s + 1] if hasattr(a, "shape") and a.dim() and a.shape[0] == args[1].shape[0]
                    else a for a in args)
        st = run_tns(fn, kern, one)[0]
        if st[-1] > 0:  # a stream with no active line has no chain
            per.append(float(st[2] - st[1]) / int(st[-1]))
    return per


def synthesis_alone_cycles(args) -> list:
    """Cycles a line of the tns_synthesis chain, each of the first four
    streams of the decode step's arguments `args` that has a filter on
    alone (S = 1)."""
    from lc3jax_torch import _build

    kern = "tns_synthesis"
    return alone_cycles(build_one(_build.find_nvcc(), kern, TNS[kern][0], TNS_ARGTYPES[kern]),
                        kern, args)


def tns_main(card: str, nvcc: str) -> dict:
    import torch

    from lc3jax_torch.coding import device as cdev
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.convert import decoder_tables
    from lc3jax_torch.dsp import decoder as D

    ptxas = {kern: ptxas_lines(nvcc, kern) for kern in TNS}
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    bench = np.load(ROOT / "tests" / "goldens" / "torch_bench_content.npz")
    tab = decoder_tables(cfg, 150 * 8, "cuda")
    fr = cdev.device_parse(cfg, 150, torch.as_tensor(bench["frames"][np.arange(S) % 4, 0], device="cuda"))
    cases = {"tns_synthesis": (tab, D.pre_tns(tab, fr), fr.bandwidth, fr.rc_order, fr.rc_i),
             "tns_analysis": bench_encoder_args()["tns_analysis"]}
    result = {"card": card, "ptxas": ptxas, "phases": {}, "alone": {}}
    for kern, args in cases.items():
        fn = build_one(nvcc, kern, TNS[kern][0], TNS_ARGTYPES[kern])
        result["phases"][kern] = summarize(run_tns(fn, kern, args), TNS[kern][1], "lines")
        result["alone"][kern] = alone_cycles(fn, kern, args)
    for key, phases in result["phases"].items():
        print(f"{key}, S={S}: " + "; ".join(f"{k} {v[0]:.0f} ({v[1]})" for k, v in phases.items()))
    for key, per in result["alone"].items():
        print(f"{key}, one stream alone, cycles a line: " + ", ".join(f"{c:.1f}" for c in per))
    return result


def build_pvq(nvcc: str):
    return build_one(nvcc, "sns_pvq", PVQ[0], [_P] * 8 + [_I] + [_P, _P])


def run_pvq(fn, t2rot) -> "np.ndarray":
    """One launch of the instrumented sns_pvq on t2rot [S, 16]; checks every
    output equal to the plain version and returns the stamps [S, phases + 2]
    (the greedy rounds last)."""
    import torch

    from lc3jax_torch.dsp import sns_kernel

    S = t2rot.shape[0]
    x = t2rot.contiguous()
    i32 = torch.int32
    outs = [x.new_empty((S, 16), dtype=i32), x.new_empty((S, 16), dtype=i32), x.new_empty((S, 16)),
            x.new_empty((S,), dtype=i32), x.new_empty((S,), dtype=i32), x.new_empty((S,))]
    stamps = torch.zeros(S, len(PVQ[1]) + 2, dtype=torch.int64, device=x.device)
    gains = torch.as_tensor(sns_kernel.GAINS, device=x.device)
    err = fn(x.data_ptr(), *[o.data_ptr() for o in outs], gains.data_ptr(), S,
             torch.cuda.current_stream().cuda_stream, stamps.data_ptr())
    if err:
        raise RuntimeError(f"sns_pvq_phase: CUDA error {err}")
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(outs, sns_kernel.sns_pvq_plain(x))):
        if not torch.equal(a, b):
            raise AssertionError(f"instrumented sns_pvq != plain (output {i})")
    return stamps.cpu().numpy()


def pvq_alone(fn, t2rot, streams=range(4)) -> tuple[list, list]:
    """(cycles a greedy round, cycles of the whole kernel) with each of
    `streams` of t2rot alone on the card (S = 1)."""
    rounds, total = [], []
    a, b = PVQ_GREEDY
    for s in streams:
        st = run_pvq(fn, t2rot[s : s + 1])[0]
        rounds.append(float(st[b] - st[a]) / max(int(st[-1]), 1))
        total.append(float(st[len(PVQ[1])] - st[0]))
    return rounds, total


def pvq_alone_cycles(t2rot) -> tuple[list, int]:
    """The cycles a greedy round of sns_pvq takes with each of the first four
    streams of t2rot alone (S = 1), and the most greedy rounds a stream of
    the whole batch t2rot needs."""
    from lc3jax_torch import _build

    fn = build_pvq(_build.find_nvcc())
    return pvq_alone(fn, t2rot)[0], int(run_pvq(fn, t2rot)[:, -1].max())


def sns_main(card: str, nvcc: str) -> dict:
    result = {"card": card, "ptxas": ptxas_lines(nvcc, "sns_pvq")}
    fn = build_pvq(nvcc)
    t2 = bench_encoder_args()["sns_pvq"][0]
    result["phases"] = summarize(run_pvq(fn, t2), PVQ[1])
    rounds, total = pvq_alone(fn, t2)
    result["alone"] = {"cycles a round": rounds, "cycles in all": total}
    print(f"sns_pvq, S={S}, cycles a stream, median (max): "
          + "; ".join(f"{k} {v[0]:.0f} ({v[1]})" for k, v in result["phases"].items()))
    print("sns_pvq, the bench's four streams alone: cycles a greedy round "
          + ", ".join(f"{c:.1f}" for c in rounds) + "; cycles in all "
          + ", ".join(f"{c:.0f}" for c in total))
    return result


def run_bitmodel(fn, args, emit: bool) -> "np.ndarray":
    """One launch of the instrumented bit model on the wrapper's arguments
    (c, g, sym, rate_flag, ne, lastnz); checks its outputs equal to the
    plain version and returns each launched block's phase cycles [blocks, 3]
    (BM_PHASES)."""
    import torch

    from lc3jax_torch.dsp import bitmodel_kernel as B

    c, g, sym, rf, ne, lnz = args
    S, NT = c.shape
    out = c.new_empty((S, NT))
    pk = c.new_empty((5 * NT, S)) if emit else None
    nthreads = (-(-S * NT // BM_THREADS) + -(-S // 32) * -(-NT // 32)) * BM_THREADS
    stamps = torch.zeros(nthreads, 4, dtype=torch.int64, device=c.device)
    err = fn(*[t.data_ptr() for t in (c, g, sym, lnz)], B.composed_tables(c.device, rf).data_ptr(),
             out.data_ptr(), pk.data_ptr() if emit else None, S, NT, ne // 4,
             torch.cuda.current_stream().cuda_stream, stamps.data_ptr())
    if err:
        raise RuntimeError(f"bitmodel_phase: CUDA error {err}")
    torch.cuda.synchronize()
    want = B.bitmodel_table_part_plain(*args, emit_pack=emit)
    for i, (a, b) in enumerate(zip((out, pk) if emit else (out,), want if emit else (want,))):
        if not torch.equal(a, b):
            raise AssertionError(f"instrumented bitmodel (emit_pack={emit}) != plain ({i})")
    st = stamps.cpu().numpy().reshape(-1, BM_THREADS, 4)
    st = st[(st[:, :, 0] != 0).any(1)]  # the launched blocks
    t0 = np.where(st[:, :, 0] != 0, st[:, :, 0], np.iinfo(np.int64).max).min(1)
    t1, t2, rows = st[:, :, 1].max(1), st[:, :, 2].max(1), st[:, :, 3].max(1)
    return np.stack([t1 - t0, t2 - t1 - rows, rows], 1)


def bitmodel_main(card: str, nvcc: str) -> dict:
    result = {"card": card, "ptxas": ptxas_lines(nvcc, "bitmodel"), "phases": {}}
    fn = build_one(nvcc, "bitmodel", BM, [_P] * 7 + [_I] * 3 + [_P, _P])
    args = bench_encoder_args()["bitmodel_table_part"]
    for emit in (False, True):
        ph = run_bitmodel(fn, args, emit)
        key = "emit_pack" if emit else "table part"
        result["phases"][key] = {k: [float(np.median(ph[:, i])), int(ph[:, i].max())]
                                 for i, k in enumerate(BM_PHASES)}
        tot = ph.sum(1)
        result["phases"][key]["total"] = [float(np.median(tot)), int(tot.max())]
        result["phases"][key]["blocks"] = int(ph.shape[0])
    for key, phases in result["phases"].items():
        print(f"bitmodel {key}, S={S}, cycles a block, median (max): "
              + "; ".join(f"{k} {v[0]:.0f} ({v[1]})" if isinstance(v, list) else f"{k} {v}"
                          for k, v in phases.items()))
    return result


def build_coefficients(nvcc: str):
    return build_one(nvcc, "tns_coefficients", COEF, [_P] * 13 + [_I] * 3 + [_P, _P])


def run_coefficients(fn, args) -> "np.ndarray":
    """One launch of the instrumented coefficient kernel on the wrapper's
    arguments (tab, x, bw_ind, near_nyquist, lpc_weighting); checks ac,
    rc_i, rc_order and nbits_tns equal to tns_coefficients_plain and the
    unquantised coefficients in rc_q equal to tns_lpc_plain's, and returns
    the stamps [S, 2, 4]."""
    import torch

    from lc3jax_torch.dsp import tns_enc_kernel as K

    tab, x, bw, nn, lpc = args
    S, ne = x.shape
    want = K.tns_coefficients_plain(*args)
    rc, _ = K.tns_lpc_plain(tab, want[0], nn, lpc)
    exists = torch.arange(2, device=x.device)[None, :] < torch.where(bw >= 3, 2, 1)[:, None]
    rc = torch.where(exists[:, :, None], rc, 0.0).reshape(S, 16)
    outs = [torch.empty_like(t) for t in want]
    stamps = torch.zeros(S, 2, 4, dtype=torch.int64, device=x.device)
    ins = [t.contiguous() for t in (x, bw, nn, tab.tns_sub, tab.lag_window, tab.tns_sin,
                                    tab.tns_bits, tab.tns_step)]
    err = fn(*[t.data_ptr() for t in ins + outs], S, ne, lpc, torch.cuda.current_stream().cuda_stream,
             stamps.data_ptr())
    if err:
        raise RuntimeError(f"tns_coefficients_phase: CUDA error {err}")
    torch.cuda.synchronize()
    for i in (0, 1, 3, 4):
        if not torch.equal(outs[i], want[i]):
            raise AssertionError(f"instrumented tns_coefficients output {i} != plain")
    if not torch.equal(outs[2], rc):
        raise AssertionError("instrumented tns_coefficients: reflection coefficients != tns_lpc_plain")
    return stamps.cpu().numpy()


def coefficient_alone_cycles(fn, args, streams=range(4)) -> list:
    """[(lag folds, epilogue)] cycles of the chain (the two phases after
    the staging) of each of `streams` alone on the card (S = 1), for the
    filter whose chain is longer."""
    per = []
    tab, x, bw, nn, lpc = args
    for s in streams:
        st = run_coefficients(fn, (tab, x[s : s + 1], bw[s : s + 1], nn[s : s + 1], lpc))[0]
        f = int(np.argmax(st[:, 3] - st[:, 1]))
        per.append((int(st[f, 2] - st[f, 1]), int(st[f, 3] - st[f, 2])))
    return per


def coefficient_chain(args) -> list:
    """The chain cycles of the first four streams of the encoder's
    arguments `args` alone (coefficient_alone_cycles)."""
    from lc3jax_torch import _build

    return coefficient_alone_cycles(build_coefficients(_build.find_nvcc()), args)


def coefficients_main(card: str, nvcc: str) -> dict:
    import chip_smoke as cs
    from lc3jax_torch.dsp import tns_enc_kernel as K

    result = {"card": card, "ptxas": ptxas_lines(nvcc, "tns_coefficients")}
    fn = build_coefficients(nvcc)
    args = bench_encoder_args()["tns_coefficients"]
    d = np.diff(run_coefficients(fn, args).reshape(S * 2, 4), axis=1)
    result["phases"] = {k: [float(np.median(d[:, i])), int(d[:, i].max())]
                        for i, k in enumerate(COEF_PHASES)}
    result["alone"] = coefficient_alone_cycles(fn, args)
    kern = lambda: K.tns_coefficients(*args)
    result["event_ms"] = cs.cuda_ms(kern, cs.PAIR_REPS)
    result["device_ms"] = cs.device_ms(kern, "tns_coefficients_kernel")
    print(f"tns_coefficients, S={S}, cycles a (stream, filter) warp, median (max): "
          + "; ".join(f"{k} {v[0]:.0f} ({v[1]})" for k, v in result["phases"].items()))
    print("one stream alone, (lag folds, epilogue) cycles: " + ", ".join(map(str, result["alone"])))
    print(f"event ms (median of {cs.PAIR_REPS}): {result['event_ms']:.4f}; device ms: "
          f"{result['device_ms']:.4f}")
    return result


def range_main(card: str, nvcc: str) -> dict:
    import torch

    import chip_smoke as cs
    from lc3jax_torch.coding import device as cdev
    from lc3jax_torch.coding import pack_kernel, parse_kernel
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.dsp.decoder import ParsedFrames
    from lc3jax_torch.dsp.encoder import encode_step, encoder_init

    ptxas = {kern: ptxas_lines(nvcc, kern) for kern in ("parse", "pack")}
    parse_fn = build_one(nvcc, "parse", PARSE[0], [_P] * 4 + [_I] * 5 + [_P, _P])
    pack_fn = build_one(nvcc, "pack", PACK[0], [_P] * 6 + [_I] * 5 + [_P, _P])
    dev = torch.device("cuda")
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    stream = torch.cuda.current_stream().cuda_stream

    def run_parse(nb: int, pay) -> np.ndarray:
        ns, ne = pay.shape[0], cfg.ne
        stamps = torch.zeros(ns, len(PARSE[1]) + 2, dtype=torch.int64, device=dev)
        n32, n8 = parse_kernel.pool_sizes(ns, ne)
        p32 = torch.empty(n32, dtype=torch.int32, device=dev)
        p8 = torch.empty(n8, dtype=torch.uint8, device=dev)
        for _ in range(3):
            if parse_fn(pay.data_ptr(), parse_kernel._device_tables(dev).data_ptr(), p32.data_ptr(),
                        p8.data_ptr(), ns, nb, ne, cfg.fs_ind, 0, stream, stamps.data_ptr()):
                raise RuntimeError("parse_phase: CUDA error")
        torch.cuda.synchronize()
        want, have = cdev.device_parse_plain(cfg, nb, pay), parse_kernel.output_views(p32, p8, ns, ne)
        for f in dataclasses.fields(ParsedFrames):
            if not torch.equal(getattr(have, f.name), getattr(want, f.name)):
                raise AssertionError(f"instrumented parse != plain on {f.name}")
        return stamps.cpu().numpy()

    def run_pack(nb: int, fields: dict) -> np.ndarray:
        ns = fields["x_q"].shape[0]
        xq, res = fields["x_q"].contiguous(), fields["residual_bits"].contiguous()
        pk = fields["quant_pack_tables"].contiguous()
        out = torch.empty(ns, nb, dtype=torch.uint8, device=dev)
        stamps = torch.zeros(ns, len(PACK[1]) + 2, dtype=torch.int64, device=dev)
        ptrs = [xq.data_ptr(), res.data_ptr(), pack_kernel.side_rows(fields).data_ptr(), pk.data_ptr(),
                pack_kernel._tables(dev).data_ptr(), out.data_ptr()]
        ints = [ns, cfg.ne, nb, pack_kernel.NBITS_BW[cfg.fs_ind], pack_kernel.lpc_weighting(cfg, nb)]
        for _ in range(3):
            err = pack_fn(*ptrs, *ints, stream, stamps.data_ptr())
            if err:
                raise RuntimeError(f"pack_phase: CUDA error {err}")
        torch.cuda.synchronize()
        if not torch.equal(out, pack_kernel.device_pack_plain(cfg, nb, fields)):
            raise AssertionError("instrumented pack != plain")
        return stamps.cpu().numpy()

    def fields_of(nb: int, pcm: np.ndarray) -> dict:
        st = encoder_init(cfg, pcm.shape[1], dev)
        for f in range(pcm.shape[0]):
            st, fields = encode_step(cfg, nb, st, torch.as_tensor(pcm[f], device=dev), emit_pack=True)
        return fields

    bench = np.load(ROOT / "tests" / "goldens" / "torch_bench_content.npz")
    tile = np.arange(S) % 4
    fields = {"bench 150 B": (150, fields_of(150, bench["pcm_in"][tile, :2].transpose(1, 0, 2))),
              "noise 150 B": (150, fields_of(150, cs.noise_pcm(cfg, S, 2, seed=4))),
              "mixed 400 B": (400, fields_of(400, cs.mixed_pcm(cfg, S, 2, seed=5)))}
    # parse reads the bench content's stored frames, as chip_smoke.py phase 9 does
    frames = {"bench 150 B": (150, torch.as_tensor(bench["frames"][tile, 0], device=dev))}
    for label in ("noise 150 B", "mixed 400 B"):
        nb, f = fields[label]
        frames[label] = (nb, pack_kernel.device_pack(cfg, nb, f))
    result = {"card": card, "ptxas": ptxas, "phases": {}, "alone": {}}
    for label, (nb, pay) in frames.items():
        result["phases"][f"parse {label}"] = summarize(run_parse(nb, pay), PARSE[1], "symbols")
    for label, (nb, f) in fields.items():
        result["phases"][f"pack {label}"] = summarize(run_pack(nb, f), PACK[1], "symbols")
    # one stream alone: the chain's own cycles per symbol, the bench's four streams
    for kern, names in (("parse", PARSE[1]), ("pack", PACK[1])):
        i = names.index("spectral tuples")
        per = []
        for s in range(4):
            if kern == "parse":
                st = run_parse(150, frames["bench 150 B"][1][s : s + 1])
            else:
                one = {k: (v[:, s : s + 1] if k == "quant_pack_tables" else v[s : s + 1])
                       if torch.is_tensor(v) else v for k, v in fields["bench 150 B"][1].items()}
                st = run_pack(150, one)
            per.append(float(st[0, i + 1] - st[0, i]) / max(int(st[0, len(names) + 1]), 1))
        result["alone"][kern] = per
    for key, phases in result["phases"].items():
        print(f"{key}: " + "; ".join(f"{k} {v[0]:.0f} ({v[1]})" for k, v in phases.items()))
    for key, per in result["alone"].items():
        print(f"{key}, one stream alone, cycles a spectral symbol: " + ", ".join(f"{c:.0f}" for c in per))
    return result


MODES = {"range": range_main, "tns": tns_main, "sns": sns_main, "bitmodel": bitmodel_main,
         "coefficients": coefficients_main}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", choices=tuple(MODES), default="range",
                    help="the range coders (parse, pack), the TNS lattices, the SNS PVQ "
                         "search, the bit model or the TNS coefficient kernel")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lc3jax_torch import _build

    card = cs.card_line()
    print(card, flush=True)
    result = MODES[args.kernels](card, _build.find_nvcc())
    result["sm_clock"] = sm_clocks()
    print(f"SM clock after the runs: {result['sm_clock']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
