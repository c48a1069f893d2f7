#!/usr/bin/env python3
"""Cycles per phase of the range-coder kernels (parse, pack), the two TNS
lattices, the SNS PVQ search or the bit model on a CUDA card, previous
kernels against current ones.

    git archive 308f410 lc3jax_torch/csrc | tar -x -C checkout_copy/prev
    python3 tools/kernel_phases.py --src checkout_copy/prev/lc3jax_torch/csrc
    git archive 49dad51 lc3jax_torch/csrc | tar -x -C checkout_copy/pr5
    python3 tools/kernel_phases.py --kernels tns --src checkout_copy/pr5/lc3jax_torch/csrc
    git archive bb65687 lc3jax_torch/csrc | tar -x -C checkout_copy/pr6
    python3 tools/kernel_phases.py --kernels sns --src checkout_copy/pr6/lc3jax_torch/csrc
    python3 tools/kernel_phases.py --kernels bitmodel --src checkout_copy/pr6/lc3jax_torch/csrc

Range coders (the default; the previous ones are commit 308f410's, one
thread a stream, the current ones a warp a stream):

Copies `parse.cu` and `pack.cu` from --src (the previous kernels) and from
`lc3jax_torch/csrc` into a temporary directory, stamps `clock64()`
at their phase boundaries and counts the symbols each stream codes, builds
them with the port's nvcc flags and runs them on `chip_smoke.py`'s inputs
at S = 2048: the bench content (its first stored frame for parse, its
fields for pack) at 48 kHz / 10 ms / 150 B, full-scale noise at 150 B
(every frame in LSB mode) and mixed content at 400 B. Each instrumented
kernel's outputs are checked equal to the plain version. Then each
version runs the bench content's four streams one at a time (S = 1, one
warp alone on the card): the spectral phase's cycles over the stream's
symbols is the chain's own latency per symbol.

Prints, per kernel, version and batch, the median and maximum over streams
of each phase's cycles, and `-Xptxas -v` of all four kernels.

TNS (`--kernels tns`; the previous lattices are commit 49dad51's, a thread
a stream over a [ne, S] copy of x, the current ones read x in place): the
analysis lattice on the arguments the encoder gives it for chip_smoke.py's
bench content, the synthesis lattice on those the decode step gives it, at
48 kHz / 10 ms / 150 B and S = 2048. Stamps per stream (per warp's lane 0
for the current analysis): the previous kernels' line loop, the current
ones' staging, walk or chain, wait for the block and store; each output
checked equal to the plain version. Then each version runs the bench's four
streams one at a time (S = 1): the chain's cycles over the stream's active
lines (for the current analysis, over the lines lane 0 walks) is its own
latency a line, and `synthesis_alone_cycles` gives chip_smoke.py the
current synthesis chain's for its floor.

SNS PVQ (`--kernels sns`; the previous search is commit bb65687's, a
thread a stream; the current one has a greedy warp, a lane a stream, and 16
search lanes a stream): on the arguments the encoder gives it for
chip_smoke.py's bench content at S = 2048, the cycles of each phase per
stream (load and projection, shapes 3, 2 and 1, and what follows the
rounds) and the greedy rounds it needed, every output checked equal to the
plain version; then the bench's first four streams alone (S = 1): the
rounds' cycles over their count is a round's own latency, and
`pvq_alone_cycles` gives chip_smoke.py the current kernel's for its chain
floor.

Bit model (`--kernels bitmodel`; the previous one is commit bb65687's, a
thread a tuple, each block staging the whole tables): on the encoder's bench
arguments at S = 2048, with and without emit_pack, the cycles of each block
staging its tables, on its tuples, and (the current kernel with emit_pack)
from the wait for the transposed operand rows to their last store; each
output checked equal to the plain version.

Each mode prints `-Xptxas -v` of both versions' kernels and ends with one
JSON line. Needs a card; the instrumented copies are never written into the
repo.
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

# Edits of each source: (anchor that occurs once, text, where: "after" or
# "before" the anchor, "after_line" its first line, or "replace" it). Each
# kernel gets a `long long* stamps` parameter, keeps its n stamps in st_[]
# and its count of spectral symbols in n_, and stores them as
# stamps[s * (n + 1) + k], the count last.
PREV_PARSE = (
    [("uint8_t* __restrict__ bad_frame_o, int S,",
      "uint8_t* __restrict__ bad_frame_o, long long* __restrict__ stamps, int S,", "replace"),
     ("  if (s >= S) return;\n", "  long long st_[9];\n  int n_ = 0;\n  st_[0] = clock64();\n", "after"),
     ("  bad = bad || f.tail_err;\n", "  st_[1] = clock64();\n", "after"),
     ("  // ---------------- spectral tuples (arithmetic_codec.rs:211-305)\n", "  st_[2] = clock64();\n", "after"),
     ("      sym = f.decode(tab + kSpecCum + 17 * pki, tab + kSpecFreq + 17 * pki, 17);\n", "      ++n_;\n", "after"),
     ("  // ---------------- residual bits (arithmetic_codec.rs:160-208, 390-405)\n", "  st_[3] = clock64();\n", "after"),
     ("  bad = bad || err || neg_budget;\n", "  st_[4] = clock64();\n", "after"),
     ("  }\n\n  uint32_t seed = 0;\n", "  st_[5] = clock64();\n", "after"),
     ("    for (int k = 0; k < ne; ++k) x[k] = 0;\n", "  st_[6] = clock64();\n", "after"),
     ("  // ---------------- outputs: every field, every stream\n", "  st_[7] = clock64();\n", "after"),
     ("  bad_frame_o[s] = bad;\n", "  __threadfence_block();\n  st_[8] = clock64();\n"
      "  for (int k_ = 0; k_ < 9; ++k_) stamps[(size_t)s * 10 + k_] = st_[k_];\n"
      "  stamps[(size_t)s * 10 + 9] = n_;\n", "after"),
     ("uint8_t* bad_frame,\n    int S,", "uint8_t* bad_frame, long long* stamps,\n    int S,", "replace"),
     ("pitch_index, bad_frame, S, nbytes,", "pitch_index, bad_frame, stamps, S, nbytes,", "replace")],
    ("side info", "TNS symbols", "spectral tuples", "residual bits", "LSB refinement",
     "seed, zeroing", "MPVQ", "output stores"))
CUR_PARSE = (
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
PACK_COMMON = [
    ("  w.uint_backward(field(kNoiseFactor), 3);\n", "  st_[2] = clock64();\n", "after"),
    ("      st.encode(w, v & 1023, uint32_t(v) >> 10);\n      if (!(lsb_mode", "      ++n_;\n", "after_line"),
    ("    st.encode(w, v & 1023, uint32_t(v) >> 10);\n    const bool halve", "    ++n_;\n", "after_line"),
    ("  st.finish(w);\n  w.final_flush();\n", "  st_[5] = clock64();\n", "before"),
]
PREV_PACK = (
    PACK_COMMON + [
        ("uint8_t* __restrict__ out, int S,",
         "uint8_t* __restrict__ out, long long* __restrict__ stamps, int S,", "replace"),
        ("  if (s >= S) return;\n", "  long long st_[7];\n  int n_ = 0;\n  st_[0] = clock64();\n", "after"),
        ("  for (int i = 0; i < nbytes; ++i) w.buf[i] = 0;\n", "  st_[1] = clock64();\n", "after"),
        ("  // ---- spectral tuples (lc3_bitstream.cc:1006-1047)", "  st_[3] = clock64();\n", "before"),
        ("  // ---- residual or LSB bits in the gap", "  st_[4] = clock64();\n", "before"),
        ("  st.finish(w);\n  w.final_flush();\n", "  __threadfence_block();\n  st_[6] = clock64();\n"
         "  for (int k_ = 0; k_ < 7; ++k_) stamps[(size_t)s * 8 + k_] = st_[k_];\n"
         "  stamps[(size_t)s * 8 + 7] = n_;\n", "after"),
        ("uint8_t* out, int S, int ne,", "uint8_t* out, long long* stamps, int S, int ne,", "replace"),
        ("xq, res, side, pk, tab, out, S,", "xq, res, side, pk, tab, out, stamps, S,", "replace")],
    ("row zeroing", "side info", "TNS symbols", "spectral tuples", "residual/LSB fill", "finish"))
CUR_PACK = (
    PACK_COMMON + [
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


# The TNS lattices. The previous ones (one thread a stream) stamp their line
# loop and count its active lines; the current ones stamp staging, walk or
# chain, the block's wait and the store, per stream (the analysis: lane 0
# of the stream's warp, and the lines it walks). Stamps are stored as
# stamps[s * (n + 1) + k], the line count last.
def _prev_tns(launch_args: str):
    return ([("float* __restrict__ out_t, int S, int ne) {",
              "float* __restrict__ out_t, long long* __restrict__ stamps, int S, int ne) {", "replace"),
             ("  if (s >= S) return;\n", "  long long st_[2];\n  int n_ = 0;\n  st_[0] = clock64();\n",
              "after"),
             ("    const int ord = in_f1 ? ord1 : ord0;\n", "    ++n_;\n", "after"),
             ("    out_t[(size_t)n * S + s] = t;\n  }\n",
              "  st_[1] = clock64();\n  stamps[(size_t)s * 3] = st_[0];\n"
              "  stamps[(size_t)s * 3 + 1] = st_[1];\n  stamps[(size_t)s * 3 + 2] = n_;\n", "after"),
             ("void* stream) {", "void* stream, long long* stamps) {", "replace"),
             (launch_args, launch_args.replace("out_t, S", "out_t, stamps, S"), "replace")],
            ("line loop",))


_STORE_TNS = ("  __syncthreads();\n  st_[4] = clock64();\n  if ({who}) {{\n"
              "    for (int k_ = 0; k_ < 5; ++k_) stamps[(size_t)({s}) * 6 + k_] = st_[k_];\n"
              "    stamps[(size_t)({s}) * 6 + 5] = n_;\n  }}\n")
PREV_TNS = {k: _prev_tns("x_t, rc_q, bounds, order, out_t, S, ne);")
            for k in ("tns_synthesis", "tns_analysis")}
CUR_TNS = {
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
TNS_SPECS = {"previous": PREV_TNS, "current": CUR_TNS}


# The SNS PVQ search. Stamps per stream and the greedy rounds the stream
# needed, last: stamps[s * (n + 1) + k]. The previous kernel's thread a
# stream stores them all; in the current one the greedy warp's lane for the
# stream stores the stamps up to the rounds' end and the count, and the
# stream's lane 0 of the search the last two (the same SM's clock).
_PVQ_ENTRY = [
    ("const float* __restrict__ gains, int S) {",
     "const float* __restrict__ gains, int S, long long* __restrict__ stamps) {", "replace"),
    ("int S, void* stream) {", "int S, void* stream, long long* stamps) {", "replace"),
    ("gains, S);", "gains, S, stamps);", "replace")]
PVQ_SPECS = {
    "previous": (_PVQ_ENTRY + [
        ("  if (s >= S) return;\n", "  long long st_[9];\n  int n_ = 0;\n  st_[0] = clock64();\n", "after"),
        ("  // shape 3: K = 6", "  st_[1] = clock64();\n", "before"),
        ("    greedy<16>(y3, ax, a, need);\n", "    n_ += need;\n", "after"),
        ("  // shape 2: two more", "  st_[2] = clock64();\n", "before"),
        ("greedy<16>(y2, ax, a, true);\n", "  n_ += 2;\n", "after"),
        ("  // shape 1: strip set B", "  st_[3] = clock64();\n", "before"),
        ("    greedy<10>(y1, ax, a, need);\n", "    n_ += need;\n", "after"),
        ("  // shape 0: y1 plus one pulse", "  st_[4] = clock64();\n", "before"),
        ("  float xq0[16], xq1[16], xq2[16], xq3[16];\n", "  st_[5] = clock64();\n", "before"),
        ("  // shape/gain search in the order", "  st_[6] = clock64();\n", "before"),
        ("#pragma unroll\n  for (int n = 0; n < 16; ++n) {  // per-lane selects", "  st_[7] = clock64();\n",
         "before"),
        ("  g_sel_out[s] = g_sel;\n", "  __threadfence_block();\n  st_[8] = clock64();\n"
         "  for (int k_ = 0; k_ < 9; ++k_) stamps[(size_t)s * 10 + k_] = st_[k_];\n"
         "  stamps[(size_t)s * 10 + 9] = n_;\n", "after")],
        ("load, projection", "shape 3", "shape 2", "shape 1", "set B, signs", "normalisations",
         "shape/gain search", "stores")),
    "current": (_PVQ_ENTRY + [
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
         "set B, barrier, shapes 1 and 0 normalised, search", "stores")),
}
PVQ_GREEDY = {"previous": (1, 4), "current": (1, 4)}  # the stamps around shapes 3, 2 and 1

# The bit model. Every thread stores its start, its end of staging, its end
# and (the current kernel with emit_pack) the cycles from the block's wait
# for the transposed operand rows to its end of storing them:
# stamps[(block * 256 + thread) * 4 + k].
BM_THREADS = 256
BM_SPECS = {
    "previous": [
        ("int ne4, int rate_flag) {\n  __shared__",
         "int ne4, int rate_flag, long long* __restrict__ stamps) {\n  __shared__", "replace"),
        ("  const bool emit = pk != nullptr;  // uniform over the launch\n",
         "  const long long t0_ = clock64();\n", "after"),
        ("  __syncthreads();\n  const long tid",
         "  __syncthreads();\n  const long long t1_ = clock64();\n"
         "  long long* sp_ = stamps + ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;\n"
         "  sp_[0] = t0_;\n  sp_[1] = t1_;\n  sp_[2] = t1_;\n  const long tid", "replace"),
        ("    }\n    return;\n  }\n", "    }\n    sp_[2] = clock64();\n    return;\n  }\n", "replace"),
        ("    pk[((long)4 * NT + n) * S + s] = s_cum[f] + 1024 * s_freq[f];\n  }\n",
         "  sp_[2] = clock64();\n", "after"),
        ("int rate_flag, void* stream) {", "int rate_flag, void* stream, long long* stamps) {", "replace"),
        ("ne4, rate_flag);", "ne4, rate_flag, stamps);", "replace")],
    "current": [
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
        ("pk, S, NT, ne4);", "pk, S, NT, ne4, stamps);", "replace_all")],
}
BM_PHASES = ("stage", "tuples", "operand rows")


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


def build_tns(nvcc: str, dirs: dict, kernels=("tns_synthesis", "tns_analysis")) -> dict:
    """{version: ctypes library} of the instrumented TNS kernels of each
    version's source directory, built with the port's nvcc flags in a
    temporary directory."""
    import ctypes

    from lc3jax_torch import _build

    tmp = Path(tempfile.mkdtemp())
    libs = {}
    for version, d in dirs.items():
        srcs = []
        for kern in kernels:
            f = tmp / f"{version}_{kern}.cu"
            f.write_text(instrument((d / f"{kern}.cu").read_text(), TNS_SPECS[version][kern][0],
                                    f"lc3t_{kern}"))
            srcs.append(str(f))
        so = tmp / f"libtns_{version}.so"
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(d), "-shared", "-o", str(so), *srcs],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"kernel_phases: nvcc failed on the {version} TNS kernels:\n{r.stderr}")
        L = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        for kern in kernels:
            fn = getattr(L, f"lc3t_{kern}_phase")
            if version == "previous":
                fn.argtypes = [P] * 5 + [I] * 2 + [P, P]
            else:
                fn.argtypes = ([P] * 7 if kern == "tns_synthesis" else [P] * 6) + [I] * 2 + [P, P]
        libs[version] = L
    return libs


def run_tns(L, version: str, kern: str, args) -> "np.ndarray":
    """One launch of the instrumented `kern` of `version` on the wrapper's
    arguments `args` (tns_synthesis: tab, x, bandwidth, rc_order, rc_i;
    tns_analysis: x, bounds, rc_order, num_filters, rc_q); checks the output
    equal to the plain version and returns the stamps [S, phases + 2]."""
    import torch

    from lc3jax_torch.dsp import tns_enc_kernel, tns_kernel

    if kern == "tns_synthesis":
        tab, x, bw, ro, ri = args
        plain = tns_kernel.tns_synthesis_plain(*args)
    else:
        x, bnd, ro, nf, rcq = args
        plain = tns_enc_kernel.tns_analysis_plain(*args)
    S, ne = x.shape
    stamps = torch.zeros(S, len(TNS_SPECS[version][kern][1]) + 2, dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    if version == "previous":
        x_t = x.t().contiguous()
        out = torch.empty_like(x_t)
        if kern == "tns_synthesis":
            ops = [tab.tns_sin[ri.long()], tab.tns_bounds[bw.long()], ro.to(torch.int32)]
        else:
            ops = [rcq, bnd.reshape(S, 4), tns_enc_kernel._orders(ro, nf)]
        ops = [t.contiguous() for t in ops]
        err = getattr(L, f"lc3t_{kern}_phase")(x_t.data_ptr(), *[t.data_ptr() for t in ops],
                                               out.data_ptr(), S, ne, stream, stamps.data_ptr())
        out = out.t()
    else:
        out = torch.empty_like(x)
        ops = [bw, ro, ri, tab.tns_bounds, tab.tns_sin] if kern == "tns_synthesis" else [bnd, ro, nf, rcq]
        ops = [t.contiguous() for t in ops]
        err = getattr(L, f"lc3t_{kern}_phase")(x.contiguous().data_ptr(), *[t.data_ptr() for t in ops],
                                               out.data_ptr(), S, ne, stream, stamps.data_ptr())
    if err:
        raise RuntimeError(f"{version} {kern}_phase: CUDA error {err}")
    torch.cuda.synchronize()
    if not torch.equal(out, plain):
        raise AssertionError(f"instrumented {version} {kern} != plain")
    return stamps.cpu().numpy()


def alone_cycles(L, version: str, kern: str, args, streams=range(4)) -> list:
    """Cycles a line of the chain phase (the line loop, or the current
    kernels' chain or lane 0's walk) with each of `streams` that has an
    active line alone on the card (S = 1)."""
    i = 0 if version == "previous" else 1
    per = []
    for s in streams:
        one = tuple(a[s : s + 1] if hasattr(a, "shape") and a.dim() and a.shape[0] == args[1].shape[0]
                    else a for a in args)
        st = run_tns(L, version, kern, one)[0]
        if st[-1] > 0:  # a stream with no active line has no chain
            per.append(float(st[i + 1] - st[i]) / int(st[-1]))
    return per


def synthesis_alone_cycles(args) -> list:
    """Cycles a line of the current tns_synthesis chain, each of the first
    four streams of the decode step's arguments `args` that has a filter on
    alone (S = 1)."""
    from lc3jax_torch import _build

    L = build_tns(_build.find_nvcc(), {"current": _build.CSRC}, ("tns_synthesis",))["current"]
    return alone_cycles(L, "current", "tns_synthesis", args)


def tns_main(src: Path) -> int:
    import torch

    import chip_smoke as cs
    from lc3jax_torch import _build
    from lc3jax_torch.coding import device as cdev
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.convert import decoder_tables
    from lc3jax_torch.dsp import decoder as D

    card = cs.card_line()
    print(card, flush=True)
    nvcc = _build.find_nvcc()
    dirs = {"previous": src, "current": _build.CSRC}
    ptxas = {}
    for version, d in dirs.items():
        for kern in ("tns_synthesis", "tns_analysis"):
            r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", "/dev/null",
                                str(d / f"{kern}.cu")], capture_output=True, text=True)
            ptxas[f"{version} {kern}"] = [ln.split(":", 1)[-1].strip() for ln in r.stderr.splitlines()
                                          if "registers" in ln or "stack frame" in ln]
            print(f"ptxas {version} {kern}: {ptxas[f'{version} {kern}']}", flush=True)
    libs = build_tns(nvcc, dirs)

    dev = torch.device("cuda")
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    bench = np.load(ROOT / "tests" / "goldens" / "torch_bench_content.npz")
    tile = np.arange(S) % 4
    tab = decoder_tables(cfg, 150 * 8, dev)
    fr = cdev.device_parse(cfg, 150, torch.as_tensor(bench["frames"][tile, 0], device=dev))
    cases = {"tns_synthesis": (tab, D.pre_tns(tab, fr), fr.bandwidth, fr.rc_order, fr.rc_i)}
    cases["tns_analysis"] = cs.capture_kernel_inputs(
        cfg, torch.as_tensor(bench["pcm_in"][tile, 0], device=dev))["tns_analysis"]
    result = {"card": card, "ptxas": ptxas, "phases": {}, "alone": {}}
    for version, L in libs.items():
        for kern, args in cases.items():
            names = TNS_SPECS[version][kern][1]
            st = run_tns(L, version, kern, args)
            d = np.diff(st[:, : len(names) + 1], axis=1)
            ph = {k: [float(np.median(d[:, i])), int(d[:, i].max())] for i, k in enumerate(names)}
            tot = st[:, len(names)] - st[:, 0]
            ph["total"] = [float(np.median(tot)), int(tot.max())]
            ph["lines"] = [float(np.median(st[:, -1])), int(st[:, -1].max())]
            result["phases"][f"{version} {kern}"] = ph
            result["alone"][f"{version} {kern}"] = alone_cycles(L, version, kern, args)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    result["sm_clock"] = clocks
    for key, phases in result["phases"].items():
        print(f"{key}, S={S}: " + "; ".join(f"{k} {v[0]:.0f} ({v[1]})" for k, v in phases.items()))
    for key, per in result["alone"].items():
        print(f"{key}, one stream alone, cycles a line: " + ", ".join(f"{c:.1f}" for c in per))
    print(f"SM clock after the runs: {clocks}")
    print(json.dumps(result))
    return 0


def build_one(nvcc: str, src: Path, kern: str, edits, tag: str, argtypes) -> "ctypes.CDLL":
    """The instrumented `kern`.cu of directory `src`, built with the port's
    nvcc flags in a temporary directory; its entry is lc3t_<kern>_phase."""
    from lc3jax_torch import _build

    tmp = Path(tempfile.mkdtemp())
    f = tmp / f"{tag}_{kern}.cu"
    f.write_text(instrument((src / f"{kern}.cu").read_text(), edits, f"lc3t_{kern}"))
    so = tmp / f"lib{tag}_{kern}.so"
    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(src), "-shared", "-o", str(so), str(f)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"kernel_phases: nvcc failed on the {tag} {kern}:\n{r.stderr}")
    L = ctypes.CDLL(str(so))
    getattr(L, f"lc3t_{kern}_phase").argtypes = argtypes
    return L


def ptxas_lines(nvcc: str, path: Path) -> list:
    """`-Xptxas -v`'s registers, spills and stack frame of each kernel in path."""
    from lc3jax_torch import _build

    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", "/dev/null", str(path)],
                       capture_output=True, text=True)
    return [ln.split(":", 1)[-1].strip() for ln in r.stderr.splitlines()
            if "registers" in ln or "stack frame" in ln or "Compiling entry" in ln]


_P, _I = ctypes.c_void_p, ctypes.c_int
PVQ_ARGTYPES = [_P] * 8 + [_I] + [_P, _P]


def build_pvq(nvcc: str, src: Path, version: str):
    return build_one(nvcc, src, "sns_pvq", PVQ_SPECS[version][0], version, PVQ_ARGTYPES)


def run_pvq(L, version: str, t2rot) -> "np.ndarray":
    """One launch of the instrumented sns_pvq of `version` on t2rot [S, 16];
    checks every output equal to the plain version and returns the stamps
    [S, phases + 2] (the greedy rounds last)."""
    import torch

    from lc3jax_torch.dsp import sns_kernel

    S = t2rot.shape[0]
    x = t2rot.contiguous()
    i32 = torch.int32
    outs = [x.new_empty((S, 16), dtype=i32), x.new_empty((S, 16), dtype=i32), x.new_empty((S, 16)),
            x.new_empty((S,), dtype=i32), x.new_empty((S,), dtype=i32), x.new_empty((S,))]
    stamps = torch.zeros(S, len(PVQ_SPECS[version][1]) + 2, dtype=torch.int64, device=x.device)
    gains = torch.as_tensor(sns_kernel.GAINS, device=x.device)
    err = L.lc3t_sns_pvq_phase(x.data_ptr(), *[o.data_ptr() for o in outs], gains.data_ptr(), S,
                               torch.cuda.current_stream().cuda_stream, stamps.data_ptr())
    if err:
        raise RuntimeError(f"{version} sns_pvq_phase: CUDA error {err}")
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(outs, sns_kernel.sns_pvq_plain(x))):
        if not torch.equal(a, b):
            raise AssertionError(f"instrumented {version} sns_pvq != plain (output {i})")
    return stamps.cpu().numpy()


def pvq_alone(L, version: str, t2rot, streams=range(4)) -> tuple[list, list]:
    """(cycles a greedy round, cycles of the whole kernel) with each of
    `streams` of t2rot alone on the card (S = 1)."""
    rounds, total = [], []
    n = len(PVQ_SPECS[version][1])
    for s in streams:
        st = run_pvq(L, version, t2rot[s : s + 1])[0]
        a, b = PVQ_GREEDY[version]
        rounds.append(float(st[b] - st[a]) / max(int(st[-1]), 1))
        total.append(float(st[n] - st[0]))
    return rounds, total


def pvq_alone_cycles(t2rot) -> tuple[list, int]:
    """For the current sns_pvq: the cycles a greedy round takes with each of
    the first four streams of t2rot alone (S = 1), and the most greedy
    rounds a stream of the whole batch t2rot needs."""
    from lc3jax_torch import _build

    L = build_pvq(_build.find_nvcc(), _build.CSRC, "current")
    return pvq_alone(L, "current", t2rot)[0], int(run_pvq(L, "current", t2rot)[:, -1].max())


def summarize(st: np.ndarray, names) -> dict:
    """Median and max over streams of each phase's cycles, the total and the
    count stored last."""
    n = len(names) + 1
    d = np.diff(st[:, :n].astype(np.int64), axis=1)
    out = {k: [float(np.median(d[:, i])), int(d[:, i].max())] for i, k in enumerate(names)}
    tot = st[:, n - 1] - st[:, 0]
    out["total"] = [float(np.median(tot)), int(tot.max())]
    out["count"] = [float(np.median(st[:, n])), int(st[:, n].max())]
    return out


def sns_main(src: Path) -> int:
    import torch

    import chip_smoke as cs
    from lc3jax_torch import _build
    from lc3jax_torch.config import FrameDuration, Lc3Config

    card = cs.card_line()
    print(card, flush=True)
    nvcc = _build.find_nvcc()
    dirs = {"previous": src, "current": _build.CSRC}
    result = {"card": card, "ptxas": {}, "phases": {}, "alone": {}}
    libs = {}
    for version, d in dirs.items():
        result["ptxas"][version] = ptxas_lines(nvcc, d / "sns_pvq.cu")
        print(f"ptxas {version} sns_pvq: {result['ptxas'][version]}", flush=True)
        libs[version] = build_pvq(nvcc, d, version)
    dev = torch.device("cuda")
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    bench = np.load(ROOT / "tests" / "goldens" / "torch_bench_content.npz")
    tile = np.arange(S) % 4
    t2 = cs.capture_kernel_inputs(cfg,
                                  torch.as_tensor(bench["pcm_in"][tile, 0], device=dev))["sns_pvq"][0]
    for version, L in libs.items():
        names = PVQ_SPECS[version][1]
        result["phases"][version] = summarize(run_pvq(L, version, t2), names)
        rounds, total = pvq_alone(L, version, t2)
        result["alone"][version] = {"cycles a round": rounds, "cycles in all": total}
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    result["sm_clock"] = clocks
    for key, phases in result["phases"].items():
        print(f"{key} sns_pvq, S={S}, cycles a stream, median (max): "
              + "; ".join(f"{k} {v[0]:.0f} ({v[1]})" for k, v in phases.items()))
    for key, a in result["alone"].items():
        print(f"{key} sns_pvq, the bench's four streams alone: cycles a greedy round "
              + ", ".join(f"{c:.1f}" for c in a["cycles a round"]) + "; cycles in all "
              + ", ".join(f"{c:.0f}" for c in a["cycles in all"]))
    print(f"SM clock after the runs: {clocks}")
    print(json.dumps(result))
    return 0


def run_bitmodel(L, version: str, args, emit: bool) -> "np.ndarray":
    """One launch of the instrumented bit model of `version` on the wrapper's
    arguments (c, g, sym, rate_flag, ne, lastnz); checks its outputs equal to
    the plain version and returns each launched block's phase cycles
    [blocks, 3] (BM_PHASES)."""
    import torch

    from lc3jax_torch.dsp import bitmodel_kernel as B

    c, g, sym, rf, ne, lnz = args
    S, NT = c.shape
    out = c.new_empty((S, NT))
    pk = c.new_empty((5 * NT, S)) if emit else None
    nthreads = (-(-S * NT // BM_THREADS) + -(-S // 32) * -(-NT // 32)) * BM_THREADS
    stamps = torch.zeros(nthreads, 4, dtype=torch.int64, device=c.device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (c, g, sym, lnz)]
    if version == "previous":
        tabs = [t.data_ptr() for t in (*B.tables(c.device), *B.coder_tables(c.device))]
        err = L.lc3t_bitmodel_phase(*ptrs, *tabs, out.data_ptr(), pk.data_ptr() if emit else None,
                                    S, NT, ne // 4, rf, stream, stamps.data_ptr())
    else:
        err = L.lc3t_bitmodel_phase(*ptrs, B.composed_tables(c.device, rf).data_ptr(), out.data_ptr(),
                                    pk.data_ptr() if emit else None, S, NT, ne // 4, stream,
                                    stamps.data_ptr())
    if err:
        raise RuntimeError(f"{version} bitmodel_phase: CUDA error {err}")
    torch.cuda.synchronize()
    want = B.bitmodel_table_part_plain(*args, emit_pack=emit)
    for i, (a, b) in enumerate(zip((out, pk) if emit else (out,), want if emit else (want,))):
        if not torch.equal(a, b):
            raise AssertionError(f"instrumented {version} bitmodel (emit_pack={emit}) != plain ({i})")
    st = stamps.cpu().numpy().reshape(-1, BM_THREADS, 4)
    st = st[(st[:, :, 0] != 0).any(1)]  # the launched blocks
    t0 = np.where(st[:, :, 0] != 0, st[:, :, 0], np.iinfo(np.int64).max).min(1)
    t1, t2, rows = st[:, :, 1].max(1), st[:, :, 2].max(1), st[:, :, 3].max(1)
    return np.stack([t1 - t0, t2 - t1 - rows, rows], 1)


def bitmodel_main(src: Path) -> int:
    import torch

    import chip_smoke as cs
    from lc3jax_torch import _build
    from lc3jax_torch.config import FrameDuration, Lc3Config

    card = cs.card_line()
    print(card, flush=True)
    nvcc = _build.find_nvcc()
    argtypes = {"previous": [_P] * 10 + [_I] * 4 + [_P, _P], "current": [_P] * 7 + [_I] * 3 + [_P, _P]}
    dirs = {"previous": src, "current": _build.CSRC}
    result = {"card": card, "ptxas": {}, "phases": {}}
    libs = {}
    for version, d in dirs.items():
        result["ptxas"][version] = ptxas_lines(nvcc, d / "bitmodel.cu")
        print(f"ptxas {version} bitmodel: {result['ptxas'][version]}", flush=True)
        libs[version] = build_one(nvcc, d, "bitmodel", BM_SPECS[version], version, argtypes[version])
    dev = torch.device("cuda")
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    bench = np.load(ROOT / "tests" / "goldens" / "torch_bench_content.npz")
    tile = np.arange(S) % 4
    args = cs.capture_kernel_inputs(cfg,
                                    torch.as_tensor(bench["pcm_in"][tile, 0], device=dev))["bitmodel_table_part"]
    for version, L in libs.items():
        for emit in (False, True):
            ph = run_bitmodel(L, version, args, emit)
            key = f"{version}{' emit_pack' if emit else ''}"
            result["phases"][key] = {k: [float(np.median(ph[:, i])), int(ph[:, i].max())]
                                     for i, k in enumerate(BM_PHASES)}
            tot = ph.sum(1)
            result["phases"][key]["total"] = [float(np.median(tot)), int(tot.max())]
            result["phases"][key]["blocks"] = int(ph.shape[0])
    for key, phases in result["phases"].items():
        print(f"{key} bitmodel, S={S}, cycles a block, median (max): "
              + "; ".join(f"{k} {v[0]:.0f} ({v[1]})" if isinstance(v, list) else f"{k} {v}"
                          for k, v in phases.items()))
    print(json.dumps(result))
    return 0


# The TNS coefficient kernel (csrc/tns_coefficients.cu), and the body it
# replaced: the lag sums alone, a thread a (stream, filter, sub-block, lag)
# folding from device memory (commit 0e22a86's csrc/tns_autocorr.cu), kept
# here verbatim so that a checkout without git times it. The current
# kernel's copy stamps, per (stream, filter) warp, its start, the end of
# the staging, of the lag folds (after a __syncwarp, so the warp's longest
# fold) and of the epilogue, as stamps[(s * 2 + f) * 4 + k], and writes the
# unquantised reflection coefficient where rc_q goes, so that the recursion
# is held op for op against tns_lpc_plain.
PREV_AUTOCORR = r"""
#include <cuda_runtime.h>
namespace {
__global__ void tns_autocorr_kernel(const float* __restrict__ x, const int* __restrict__ sub,
                                    float* __restrict__ out, int S, int ne) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= S * 54) return;
  const int s = tid / 54;
  const int r = tid - 54 * s;  // (f * 3 + sb) * 9 + k
  const int blk = r / 9;
  const int k = r - 9 * blk;
  const int lo = sub[12 * s + 2 * blk];
  const int hi = sub[12 * s + 2 * blk + 1];
  const float* xs = x + (size_t)s * ne;
  float acc = 0.0f;
  for (int n = lo; n + k < hi; ++n) acc = acc + xs[n] * xs[n + k];
  out[tid] = acc;
}
}  // namespace
extern "C" int lc3t_tns_autocorr(const float* x, const int* sub, float* out, int S, int ne,
                                 void* stream) {
  const int threads = 128;
  const int blocks = (S * 54 + threads - 1) / threads;
  tns_autocorr_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, sub, out, S, ne);
  return static_cast<int>(cudaGetLastError());
}
"""
COEF_PHASES = ("stage", "lag folds", "epilogue")
CUR_COEF = [
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


def build_coefficients(nvcc: str):
    """(the instrumented current coefficient kernel, the previous lag-sum
    body), each a ctypes library built with the port's nvcc flags in a
    temporary directory."""
    from lc3jax_torch import _build

    cur = build_one(nvcc, _build.CSRC, "tns_coefficients", CUR_COEF, "current",
                    [_P] * 13 + [_I] * 3 + [_P, _P])
    tmp = Path(tempfile.mkdtemp())
    (tmp / "tns_autocorr.cu").write_text(PREV_AUTOCORR)
    so = tmp / "libprev_tns_autocorr.so"
    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(tmp / "tns_autocorr.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"kernel_phases: nvcc failed on the previous tns_autocorr:\n{r.stderr}")
    prev = ctypes.CDLL(str(so))
    prev.lc3t_tns_autocorr.argtypes = [_P] * 3 + [_I] * 2 + [_P]
    return cur, prev


def run_coefficients(L, args) -> "np.ndarray":
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
    err = L.lc3t_tns_coefficients_phase(*[t.data_ptr() for t in ins + outs], S, ne, lpc,
                                        torch.cuda.current_stream().cuda_stream, stamps.data_ptr())
    if err:
        raise RuntimeError(f"tns_coefficients_phase: CUDA error {err}")
    torch.cuda.synchronize()
    for i in (0, 1, 3, 4):
        if not torch.equal(outs[i], want[i]):
            raise AssertionError(f"instrumented tns_coefficients output {i} != plain")
    if not torch.equal(outs[2], rc):
        raise AssertionError("instrumented tns_coefficients: reflection coefficients != tns_lpc_plain")
    return stamps.cpu().numpy()


def coefficient_alone_cycles(L, args, streams=range(4)) -> list:
    """[(lag folds, epilogue)] cycles of the chain (the two phases after
    the staging) of each of `streams` alone on the card (S = 1), for the
    filter whose chain is longer."""
    per = []
    for s in streams:
        tab, x, bw, nn, lpc = args
        st = run_coefficients(L, (tab, x[s : s + 1], bw[s : s + 1], nn[s : s + 1], lpc))[0]
        f = int(np.argmax(st[:, 3] - st[:, 1]))
        per.append((int(st[f, 2] - st[f, 1]), int(st[f, 3] - st[f, 2])))
    return per


def coefficient_chain(args):
    """For chip_smoke.py: the chain cycles of the first four streams of the
    encoder's arguments `args` alone (coefficient_alone_cycles), and a
    function that launches the previous lag-sum body on the same x and
    sub-blocks (one launch a call, on the current stream)."""
    import torch

    from lc3jax_torch import _build

    L, prev = build_coefficients(_build.find_nvcc())
    tab, x, bw = args[:3]
    sub = tab.tns_sub[bw.long()].contiguous()
    xc = x.contiguous()
    out = xc.new_empty((x.shape[0], 2, 3, 9))

    def prev_body():
        err = prev.lc3t_tns_autocorr(xc.data_ptr(), sub.data_ptr(), out.data_ptr(), x.shape[0],
                                     x.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"previous tns_autocorr: CUDA error {err}")
        return out

    return coefficient_alone_cycles(L, args), prev_body


def coefficients_main() -> int:
    import torch

    import chip_smoke as cs
    from lc3jax_torch import _build
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.dsp import tns_enc_kernel as K

    card = cs.card_line()
    print(card, flush=True)
    nvcc = _build.find_nvcc()
    tmp = Path(tempfile.mkdtemp())
    (tmp / "tns_autocorr.cu").write_text(PREV_AUTOCORR)
    ptxas = {"previous tns_autocorr": ptxas_lines(nvcc, tmp / "tns_autocorr.cu"),
             "current tns_coefficients": ptxas_lines(nvcc, _build.CSRC / "tns_coefficients.cu")}
    for k, v in ptxas.items():
        print(f"ptxas {k}: {v}", flush=True)
    L, _ = build_coefficients(nvcc)
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    bench = np.load(ROOT / "tests" / "goldens" / "torch_bench_content.npz")
    tile = np.arange(S) % 4
    args = cs.capture_kernel_inputs(cfg, torch.as_tensor(bench["pcm_in"][tile, 0], device="cuda"))[
        "tns_coefficients"]
    st = run_coefficients(L, args).reshape(S * 2, 4)
    d = np.diff(st, axis=1)
    result = {"card": card, "ptxas": ptxas,
              "phases": {k: [float(np.median(d[:, i])), int(d[:, i].max())]
                         for i, k in enumerate(COEF_PHASES)}}
    result["alone"], prev_body = coefficient_chain(args)
    kern = lambda: K.tns_coefficients(*args)
    result["event_ms"] = dict(zip(("current", "previous"), cs.cuda_ms_pair(kern, prev_body, 200)))
    result["device_ms"] = {"current": cs.device_ms(kern, "tns_coefficients_kernel"),
                           "previous": cs.device_ms(prev_body, "tns_autocorr_kernel")}
    result["sm_clock"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"tns_coefficients, S={S}, cycles a (stream, filter) warp, median (max): "
          + "; ".join(f"{k} {v[0]:.0f} ({v[1]})" for k, v in result["phases"].items()))
    print("one stream alone, (lag folds, epilogue) cycles: " + ", ".join(map(str, result["alone"])))
    print(f"event ms (alternated, median of 200): {result['event_ms']}; device ms: "
          f"{result['device_ms']}; SM clock {result['sm_clock']}")
    print(json.dumps(result))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path,
                    help="directory with the previous kernels' sources (every mode but "
                         "coefficients, which carries its previous body)")
    ap.add_argument("--kernels", choices=("range", "tns", "sns", "bitmodel", "coefficients"),
                    default="range",
                    help="the range coders (parse, pack), the TNS lattices, the SNS PVQ "
                         "search, the bit model or the TNS coefficient kernel")
    args = ap.parse_args()
    if args.src is None and args.kernels != "coefficients":
        ap.error("--src is required for --kernels " + args.kernels)

    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    if args.kernels == "tns":
        return tns_main(args.src)
    if args.kernels == "coefficients":
        return coefficients_main()
    if args.kernels == "sns":
        return sns_main(args.src)
    if args.kernels == "bitmodel":
        return bitmodel_main(args.src)
    import chip_smoke as cs
    from lc3jax_torch import _build
    from lc3jax_torch import tables as T
    from lc3jax_torch.coding import device as cdev
    from lc3jax_torch.coding import pack_kernel, parse_kernel
    from lc3jax_torch.config import FrameDuration, Lc3Config
    from lc3jax_torch.dsp.decoder import BOOL_FRAME_FIELDS, ParsedFrames
    from lc3jax_torch.dsp.encoder import encode_step, encoder_init

    card = cs.card_line()
    print(card, flush=True)
    nvcc = _build.find_nvcc()
    dirs = {"previous": args.src, "current": _build.CSRC}
    specs = {("previous", "parse"): PREV_PARSE, ("current", "parse"): CUR_PARSE,
             ("previous", "pack"): PREV_PACK, ("current", "pack"): CUR_PACK}
    tmp = Path(tempfile.mkdtemp())
    ptxas, libs = {}, {}
    for version, d in dirs.items():
        srcs = []
        for kern in ("parse", "pack"):
            r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", "/dev/null",
                                str(d / f"{kern}.cu")], capture_output=True, text=True)
            ptxas[f"{version} {kern}"] = [ln.split(":", 1)[-1].strip() for ln in r.stderr.splitlines()
                                          if "registers" in ln or "stack frame" in ln]
            print(f"ptxas {version} {kern}: {ptxas[f'{version} {kern}']}", flush=True)
            f = tmp / f"{version}_{kern}.cu"
            f.write_text(instrument((d / f"{kern}.cu").read_text(), specs[version, kern][0],
                                    f"lc3t_{kern}"))
            srcs.append(str(f))
        so = tmp / f"lib{version}.so"
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(d), "-shared", "-o", str(so), *srcs],
                           capture_output=True, text=True)
        if r.returncode:
            print(r.stderr, file=sys.stderr)
            return 1
        L = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        L.lc3t_parse_phase.argtypes = ([P] * 23 + [I] * 5 + [P] if version == "previous"
                                       else [P] * 4 + [I] * 5 + [P, P])
        L.lc3t_pack_phase.argtypes = ([P] * 7 + [I] * 5 + [P] if version == "previous"
                                      else [P] * 6 + [I] * 5 + [P, P])
        libs[version] = L

    dev = torch.device("cuda")
    cfg = Lc3Config.new(48000, FrameDuration.MS10)
    stream = torch.cuda.current_stream().cuda_stream
    # the previous kernel's int32 table buffer (its parse_kernel.table_buffer)
    tab32 = torch.as_tensor(np.concatenate([np.asarray(t, np.int64).ravel() for t in (
        T.AC_SPEC_CUMFREQ, T.AC_SPEC_FREQ, T.AC_SPEC_LOOKUP, T.AC_TNS_ORDER_CUMFREQ,
        T.AC_TNS_ORDER_FREQ, T.AC_TNS_COEF_CUMFREQ, T.AC_TNS_COEF_FREQ, T.MPVQ_OFFSETS)])
        .astype(np.int32), device=dev)

    def summary(st: np.ndarray, names) -> dict:
        n = len(names) + 1
        d = np.diff(st[:, :n].astype(np.int64), axis=1)
        out = {k: [float(np.median(d[:, i])), int(d[:, i].max())] for i, k in enumerate(names)}
        tot = st[:, n - 1] - st[:, 0]
        out["total"] = [float(np.median(tot)), int(tot.max())]
        out["symbols"] = [float(np.median(st[:, n])), int(st[:, n].max())]
        return out

    def run_parse(version: str, nb: int, pay) -> np.ndarray:
        ns, ne = pay.shape[0], cfg.ne
        names = specs[version, "parse"][1]
        stamps = torch.zeros(ns, len(names) + 2, dtype=torch.int64, device=dev)
        L = libs[version]
        if version == "previous":
            shapes = {"x_int": (ns, ne), "rc_order": (ns, 2), "rc_i": (ns, 16),
                      "residual_bits": (ns, ne), "sns_y": (ns, 16)}
            out = {f.name: torch.empty(shapes.get(f.name, (ns,)), device=dev,
                                       dtype=torch.bool if f.name in BOOL_FRAME_FIELDS else torch.int32)
                   for f in dataclasses.fields(ParsedFrames)}
            save = torch.empty((ne // 2, ns), dtype=torch.int32, device=dev)
            call = lambda: L.lc3t_parse_phase(  # noqa: E731
                pay.data_ptr(), tab32.data_ptr(), save.data_ptr(),
                *[out[f.name].data_ptr() for f in dataclasses.fields(ParsedFrames)],
                stamps.data_ptr(), ns, nb, ne, cfg.fs_ind, 0, stream)
            got = lambda: ParsedFrames(**out)  # noqa: E731
        else:
            n32, n8 = parse_kernel.pool_sizes(ns, ne)
            p32 = torch.empty(n32, dtype=torch.int32, device=dev)
            p8 = torch.empty(n8, dtype=torch.uint8, device=dev)
            call = lambda: L.lc3t_parse_phase(  # noqa: E731
                pay.data_ptr(), parse_kernel._device_tables(dev).data_ptr(), p32.data_ptr(),
                p8.data_ptr(), ns, nb, ne, cfg.fs_ind, 0, stream, stamps.data_ptr())
            got = lambda: parse_kernel.output_views(p32, p8, ns, ne)  # noqa: E731
        for _ in range(3):
            if call():
                raise RuntimeError(f"{version} parse_phase: CUDA error")
        torch.cuda.synchronize()
        want, have = cdev.device_parse_plain(cfg, nb, pay), got()
        for f in dataclasses.fields(ParsedFrames):
            if not torch.equal(getattr(have, f.name), getattr(want, f.name)):
                raise AssertionError(f"instrumented {version} parse != plain on {f.name}")
        return stamps.cpu().numpy()

    def run_pack(version: str, nb: int, fields: dict) -> np.ndarray:
        ns = fields["x_q"].shape[0]
        xq, res = fields["x_q"].contiguous(), fields["residual_bits"].contiguous()
        pk = fields["quant_pack_tables"].contiguous()
        side = pack_kernel.side_rows(fields)
        out = torch.empty(ns, nb, dtype=torch.uint8, device=dev)
        names = specs[version, "pack"][1]
        stamps = torch.zeros(ns, len(names) + 2, dtype=torch.int64, device=dev)
        ptrs = [xq.data_ptr(), res.data_ptr(), side.data_ptr(), pk.data_ptr(),
                pack_kernel._tables(dev).data_ptr(), out.data_ptr()]
        ints = [ns, cfg.ne, nb, pack_kernel.NBITS_BW[cfg.fs_ind], pack_kernel.lpc_weighting(cfg, nb)]
        for _ in range(3):
            err = (libs[version].lc3t_pack_phase(*ptrs, stamps.data_ptr(), *ints, stream)
                   if version == "previous" else
                   libs[version].lc3t_pack_phase(*ptrs, *ints, stream, stamps.data_ptr()))
            if err:
                raise RuntimeError(f"{version} pack_phase: CUDA error {err}")
        torch.cuda.synchronize()
        if not torch.equal(out, pack_kernel.device_pack_plain(cfg, nb, fields)):
            raise AssertionError(f"instrumented {version} pack != plain")
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
    spectral = {"parse": "spectral tuples", "pack": "spectral tuples"}
    for version in dirs:
        for label, (nb, pay) in frames.items():
            result["phases"][f"{version} parse {label}"] = summary(
                run_parse(version, nb, pay), specs[version, "parse"][1])
        for label, (nb, f) in fields.items():
            result["phases"][f"{version} pack {label}"] = summary(
                run_pack(version, nb, f), specs[version, "pack"][1])
        # one stream alone: the chain's own cycles per symbol, the bench's four streams
        for kern in ("parse", "pack"):
            names = specs[version, kern][1]
            i = names.index(spectral[kern])
            per = []
            for s in range(4):
                if kern == "parse":
                    st = run_parse(version, 150, frames["bench 150 B"][1][s : s + 1])
                else:
                    one = {k: (v[:, s : s + 1] if k == "quant_pack_tables" else v[s : s + 1])
                           if torch.is_tensor(v) else v for k, v in fields["bench 150 B"][1].items()}
                    st = run_pack(version, 150, one)
                per.append(float(st[0, i + 1] - st[0, i]) / max(int(st[0, len(names) + 1]), 1))
            result["alone"][f"{version} {kern}"] = per
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    result["sm_clock"] = clocks
    for key, phases in result["phases"].items():
        print(f"{key}: " + "; ".join(f"{k} {v[0]:.0f} ({v[1]})" for k, v in phases.items()))
    for key, per in result["alone"].items():
        print(f"{key}, one stream alone, cycles a spectral symbol: "
              + ", ".join(f"{c:.0f}" for c in per))
    print(f"SM clock after the runs: {clocks}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
