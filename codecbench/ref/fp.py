"""Float32 scalar math helpers for the reference-exact oracle.

The Rust reference does its float math in f32 and routes transcendental
functions (`sinf`, `cosf`, `powf`, ...) through the system libm — the same
libm this process can call via ctypes. Using the *same* binary functions
removes any cross-library 1-ulp discrepancies, which matters because the
encoder's discrete decisions (quantizer comparisons, argmax searches) sit on
f32 knife edges (SURVEY.md section 7.3 item 2).

`exp2_raw` reproduces the `fast-math` crate's bit-twiddling exp2
approximation used by the reference decoder SNS
(decoder/spectral_noise_shaping.rs:122); verified against the reference's
golden vectors in tests/test_decoder_stages.py.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

F32 = np.float32

_libm = ctypes.CDLL(ctypes.util.find_library("m"))


def _unary_f32(name: str):
    fn = getattr(_libm, name)
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float]

    def wrapped(x) -> np.float32:
        return F32(fn(ctypes.c_float(float(x))))

    return wrapped


def _binary_f32(name: str):
    fn = getattr(_libm, name)
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]

    def wrapped(x, y) -> np.float32:
        return F32(fn(ctypes.c_float(float(x)), ctypes.c_float(float(y))))

    return wrapped


sinf = _unary_f32("sinf")
cosf = _unary_f32("cosf")
expf = _unary_f32("expf")
exp2f = _unary_f32("exp2f")
log2f = _unary_f32("log2f")
log10f = _unary_f32("log10f")
asinf = _unary_f32("asinf")
sqrtf = _unary_f32("sqrtf")
fabsf = _unary_f32("fabsf")
powf = _binary_f32("powf")


def seq_sum(arr) -> np.float32:
    """Left-to-right sequential f32 sum (Rust `iter().sum::<f32>()` order).

    np.sum uses pairwise summation which rounds differently; np.cumsum
    accumulates strictly sequentially, so its last element reproduces the
    reference's fold order bit-exactly.
    """
    arr = np.asarray(arr, dtype=F32)
    if arr.size == 0:
        return F32(0.0)
    return np.cumsum(arr)[-1]


def seq_dot(a, b) -> np.float32:
    """Sequential f32 dot product: sum of elementwise products in order."""
    return seq_sum(np.asarray(a, dtype=F32) * np.asarray(b, dtype=F32))


_EXP2_C0 = F32(1.0017247)
_EXP2_C1 = F32(0.65763628)
_EXP2_C2 = F32(0.33718944)


def exp2_raw(x) -> np.float32:
    """fast-math crate exp2 approximation (no range clamping).

    2^x = 2^floor(x) * p(frac(x)) with the quadratic minimax polynomial
    p(z) = 1.0017247 + z*(0.65763628 + z*0.33718944); the 2^floor scaling is
    an exact exponent-field add. Coefficients and evaluation order were
    recovered from (and are verified bit-exactly against) the reference's
    decoder SNS golden vectors, which use fast_math::exp2_raw
    (decoder/spectral_noise_shaping.rs:122).
    """
    x = F32(x)
    w = np.floor(x)
    z = F32(x - w)
    approx = _EXP2_C0 + z * (_EXP2_C1 + z * _EXP2_C2)
    bits = np.frombuffer(F32(approx).tobytes(), dtype=np.int32)[0]
    bits = np.int32(bits + (np.int32(w) << 23))
    return np.frombuffer(bits.tobytes(), dtype=F32)[0]
