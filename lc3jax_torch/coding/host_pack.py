"""The host packer: encoder fields -> frame bytes with the repo's C++
bitstream codec (port of lc3jax/coding/native.py:pack_frames_native).

`native/lc3_bitstream.cc` (the range encoder, the side-info and the tail
bit writer, and the parser that `coding/host_parse.py` binds, threaded over
streams) is compiled at first use with the host C++ compiler into
`build/lc3jax_torch/`, keyed by a hash of the source and the flags, and
bound here through ctypes (`SIGNATURES`, one library for both directions):

    c++ -O3 -fPIC -shared -std=c++17 -pthread -o liblc3bitstream_<hash>.so
        native/lc3_bitstream.cc

No `-march=native`: the library runs on whatever host the card sits in. A
missing compiler or a failed build raises; there is no Python packer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .. import tables as T
from ..config import Lc3Config

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "native" / "lc3_bitstream.cc"
BUILD_DIR = ROOT / "build" / "lc3jax_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
N_THREADS = 8  # the packer's and the parser's worker threads over streams

_C16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_C32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_CU8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_INT = ctypes.c_int
# C signatures: name -> (argtypes, restype)
SIGNATURES = {
    "lc3_load_tables": ([_C16, _C16, _CU8, _C16, _C16, _C16, _C16, _C32], None),
    # returns the frames rejected (zeroed)
    "lc3_pack_frames": ([_INT] * 4 + [_C32, _INT] + [_C32] * 8
                        + [_INT, _C32, _C32, _CU8, _CU8, _C32, _C32, _C32, _INT,
                           _C32, _CU8, _C32, _C32, _CU8, _C32, _CU8], _INT),
    # returns the bad frames (every output of their rows zeroed)
    "lc3_parse_frames": ([_CU8] + [_INT] * 6
                         + [_C32, _CU8, _C32, _C32, _C32, _C32, _C32, _C32, _CU8, _CU8,
                            _C32, _C32, _C32, _C32, _C32, _C32, _CU8, _C32, _CU8], _INT),
}

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblc3bitstream_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the packer if the hashed library is missing; return its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("lc3jax_torch: no C++ compiler (c++, g++, $CXX) for the host packer")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"lc3jax_torch: the host packer failed to build "
                           f"({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The packer and parser library with its tables loaded, built on first
    call. Bound with ctypes.CDLL, which releases the GIL for each call, so a
    parse or pack on one thread overlaps Python on another."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    lib.lc3_load_tables(
        np.ascontiguousarray(T.AC_SPEC_FREQ, np.int16),
        np.ascontiguousarray(T.AC_SPEC_CUMFREQ, np.int16),
        np.ascontiguousarray(T.AC_SPEC_LOOKUP, np.uint8),
        np.ascontiguousarray(T.AC_TNS_ORDER_FREQ, np.int16),
        np.ascontiguousarray(T.AC_TNS_ORDER_CUMFREQ, np.int16),
        np.ascontiguousarray(T.AC_TNS_COEF_FREQ, np.int16),
        np.ascontiguousarray(T.AC_TNS_COEF_CUMFREQ, np.int16),
        np.ascontiguousarray(T.MPVQ_OFFSETS, np.int32),
    )
    _lib = lib
    return _lib


def pack_frames(cfg: Lc3Config, fields: dict, nbytes: int) -> np.ndarray:
    """Encoder fields (numpy, the names of encode_step) -> uint8 [S, nbytes]."""
    lib = load()
    f = {k: np.asarray(v) for k, v in fields.items()}
    ne = cfg.ne
    S = f["x_q"].shape[0]
    out = np.zeros((S, nbytes), np.uint8)
    i32 = lambda k: np.ascontiguousarray(f[k], np.int32).reshape(S, -1)
    u8 = lambda k: np.ascontiguousarray(f[k], np.uint8).reshape(S, -1)
    n_rejected = lib.lc3_pack_frames(
        S, nbytes, ne, N_THREADS,
        i32("bandwidth"), int(f["nbits_bw"]),
        i32("sns_ind_lf"), i32("sns_ind_hf"), i32("sns_shape_j"),
        i32("sns_gind"), i32("sns_ls_inda"), i32("sns_ls_indb"),
        i32("sns_index_joint_j"), i32("tns_num_tns_filters"),
        int(f["tns_lpc_weighting"]), i32("tns_rc_order"), i32("tns_rc_i"),
        u8("ltpf_pitch_present"), u8("ltpf_ltpf_active"),
        i32("ltpf_pitch_index"), i32("quant_lastnz_trunc"),
        i32("quant_gg_ind"), int(np.asarray(f["quant_rate_flag"]).reshape(-1)[0]),
        i32("quant_nbits_lsb"), u8("quant_lsb_mode"), i32("noise_factor"),
        i32("x_q"), u8("residual_bits"), i32("n_residual"), out,
    )
    if n_rejected:
        # inconsistent fields are a programming error of the encode path,
        # never a property of the data: fail loudly
        raise ValueError(f"host pack rejected {n_rejected}/{S} frames (inconsistent "
                         "encoder fields; rejected rows zeroed)")
    return out
