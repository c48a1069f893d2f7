"""Float32-faithful mixed-radix FFT and DCT-IV for the oracle.

The LC3 low-delay MDCT is built on a DCT-IV of length nf, computed through a
complex FFT of length nf/2 with pre/post twiddles (reference:
common/dct_iv.rs:49-67). For bit-exact parity with the reference's float32
results, this module reproduces the same butterfly decomposition and
operation order (a kissfft-style recursion, reference common/kissfft.rs),
with each radix stage vectorised over the butterfly index (per-index ops are
independent, so vectorisation preserves every individual f32 rounding).

Complex values are carried as separate float32 (re, im) arrays; a complex
multiply is (ar*br - ai*bi, ar*bi + ai*br) evaluated in f32 exactly as the
reference's Complex::mul (common/complex.rs:16-24).

This module exists to pin correctness, not for speed.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _factorize(n: int) -> list[tuple[int, int]]:
    """kissfft factorisation: powers of 4, then 2, 3, remaining primes."""
    factors = []
    p = 4
    floor_sqrt = math.floor(math.sqrt(n))
    while n > 1:
        while n % p != 0:
            if p == 4:
                p = 2
            elif p == 2:
                p = 3
            else:
                p += 2
            if p > floor_sqrt:
                p = n
        n //= p
        factors.append((p, n))
    return factors


class FaithfulFFT:
    """Forward complex FFT matching the reference's f32 results exactly."""

    def __init__(self, nfft: int):
        self.nfft = nfft
        phase = np.array([-2.0 * math.pi * i / nfft for i in range(nfft)])
        self.twr = np.cos(phase).astype(F32)
        self.twi = np.sin(phase).astype(F32)
        self.factors = _factorize(nfft)

    def __call__(self, fin_r: np.ndarray, fin_i: np.ndarray):
        fout_r = np.zeros(self.nfft, dtype=F32)
        fout_i = np.zeros(self.nfft, dtype=F32)
        self._work(fout_r, fout_i, fin_r, fin_i, 1, 0, 0, 0)
        return fout_r, fout_i

    def _work(self, fout_r, fout_i, fin_r, fin_i, fstride, stage, fin_idx, fout_idx):
        p, m = self.factors[stage]
        begin, end = fout_idx, fout_idx + p * m
        if m == 1:
            idx = fin_idx + fstride * np.arange(p * m)
            fout_r[begin:end] = fin_r[idx]
            fout_i[begin:end] = fin_i[idx]
        else:
            while fout_idx != end:
                self._work(fout_r, fout_i, fin_r, fin_i, fstride * p, stage + 1, fin_idx, fout_idx)
                fin_idx += fstride
                fout_idx += m
        seg_r = fout_r[begin:end]
        seg_i = fout_i[begin:end]
        if p == 2:
            self._bfly2(seg_r, seg_i, fstride, m)
        elif p == 3:
            self._bfly3(seg_r, seg_i, fstride, m)
        elif p == 4:
            self._bfly4(seg_r, seg_i, fstride, m)
        elif p == 5:
            self._bfly5(seg_r, seg_i, fstride, m)
        else:
            self._bfly_generic(seg_r, seg_i, fstride, m, p)

    def _tw(self, step: int, m: int):
        idx = step * np.arange(m)
        return self.twr[idx], self.twi[idx]

    def _bfly2(self, fr, fi, fstride, m):
        twr, twi = self._tw(fstride, m)
        tr, ti = _cmul(fr[m:], fi[m:], twr, twi)
        fr[m:] = fr[:m] - tr
        fi[m:] = fi[:m] - ti
        fr[:m] += tr
        fi[:m] += ti

    def _bfly4(self, fr, fi, fstride, m):
        t1r, t1i = self._tw(fstride, m)
        t2r, t2i = self._tw(fstride * 2, m)
        t3r, t3i = self._tw(fstride * 3, m)
        s0r, s0i = _cmul(fr[m : 2 * m], fi[m : 2 * m], t1r, t1i)
        s1r, s1i = _cmul(fr[2 * m : 3 * m], fi[2 * m : 3 * m], t2r, t2i)
        s2r, s2i = _cmul(fr[3 * m :], fi[3 * m :], t3r, t3i)
        s5r = fr[:m] - s1r
        s5i = fi[:m] - s1i
        fr[:m] += s1r
        fi[:m] += s1i
        s3r = s0r + s2r
        s3i = s0i + s2i
        s4r = s0r - s2r
        s4i = s0i - s2i
        fr[2 * m : 3 * m] = fr[:m] - s3r
        fi[2 * m : 3 * m] = fi[:m] - s3i
        fr[:m] += s3r
        fi[:m] += s3i
        # forward transform (inverse=false) branch of kissfft.rs:169-170
        fr[m : 2 * m] = s5r + s4i
        fi[m : 2 * m] = s5i - s4r
        fr[3 * m :] = s5r - s4i
        fi[3 * m :] = s5i + s4r

    def _bfly3(self, fr, fi, fstride, m):
        epi3_i = self.twi[fstride * m]
        t1r, t1i = self._tw(fstride, m)
        t2r, t2i = self._tw(fstride * 2, m)
        s1r, s1i = _cmul(fr[m : 2 * m], fi[m : 2 * m], t1r, t1i)
        s2r, s2i = _cmul(fr[2 * m :], fi[2 * m :], t2r, t2i)
        s3r = s1r + s2r
        s3i = s1i + s2i
        s0r = s1r - s2r
        s0i = s1i - s2i
        fmr = fr[:m] - s3r * F32(0.5)
        fmi = fi[:m] - s3i * F32(0.5)
        s0r = s0r * epi3_i
        s0i = s0i * epi3_i
        fr[:m] += s3r
        fi[:m] += s3i
        fr[2 * m :] = fmr + s0i
        fi[2 * m :] = fmi - s0r
        fr[m : 2 * m] = fmr - s0i
        fi[m : 2 * m] = fmi + s0r

    def _bfly5(self, fr, fi, fstride, m):
        ya_r, ya_i = self.twr[fstride * m], self.twi[fstride * m]
        yb_r, yb_i = self.twr[fstride * 2 * m], self.twi[fstride * 2 * m]
        t1r, t1i = self._tw(fstride, m)
        t2r, t2i = self._tw(fstride * 2, m)
        t3r, t3i = self._tw(fstride * 3, m)
        t4r, t4i = self._tw(fstride * 4, m)
        s0r, s0i = fr[:m].copy(), fi[:m].copy()
        s1r, s1i = _cmul(fr[m : 2 * m], fi[m : 2 * m], t1r, t1i)
        s2r, s2i = _cmul(fr[2 * m : 3 * m], fi[2 * m : 3 * m], t2r, t2i)
        s3r, s3i = _cmul(fr[3 * m : 4 * m], fi[3 * m : 4 * m], t3r, t3i)
        s4r, s4i = _cmul(fr[4 * m :], fi[4 * m :], t4r, t4i)
        s7r, s7i = s1r + s4r, s1i + s4i
        s10r, s10i = s1r - s4r, s1i - s4i
        s8r, s8i = s2r + s3r, s2i + s3i
        s9r, s9i = s2r - s3r, s2i - s3i
        fr[:m] += s7r + s8r
        fi[:m] += s7i + s8i
        s5r = s0r + (s7r * ya_r) + (s8r * yb_r)
        s5i = s0i + (s7i * ya_r) + (s8i * yb_r)
        s6r = (s10i * ya_i) + (s9i * yb_i)
        s6i = -(s10r * ya_i) - (s9r * yb_i)
        fr[m : 2 * m] = s5r - s6r
        fi[m : 2 * m] = s5i - s6i
        fr[4 * m :] = s5r + s6r
        fi[4 * m :] = s5i + s6i
        s11r = s0r + (s7r * yb_r) + (s8r * ya_r)
        s11i = s0i + (s7i * yb_r) + (s8i * ya_r)
        s12r = -(s10i * yb_i) + (s9i * ya_i)
        s12i = (s10r * yb_i) - (s9r * ya_i)
        fr[2 * m : 3 * m] = s11r + s12r
        fi[2 * m : 3 * m] = s11i + s12i
        fr[3 * m : 4 * m] = s11r - s12r
        fi[3 * m : 4 * m] = s11i - s12i

    def _bfly_generic(self, fr, fi, fstride, m, p):
        # not reached for LC3 sizes (all factors are in {2,3,4,5}); kept for
        # completeness, sequential per kissfft.rs:258-288
        for u in range(m):
            sr = fr[u::m].copy()
            si = fi[u::m].copy()
            k = u
            for _ in range(p):
                twidx = 0
                accr, acci = sr[0], si[0]
                for q in range(1, p):
                    twidx += fstride * k
                    if twidx >= self.nfft:
                        twidx -= self.nfft
                    tr, ti = _cmul(sr[q], si[q], self.twr[twidx], self.twi[twidx])
                    accr = accr + tr
                    acci = acci + ti
                fr[k], fi[k] = accr, acci
                k += m


class FaithfulDctIV:
    """DCT-IV of length nf via the half-length FFT (dct_iv.rs:49-67)."""

    def __init__(self, nf: int):
        self.nf = nf
        count = nf // 2
        self.fft = FaithfulFFT(count)
        temp = np.array(
            [-math.pi * (8 * i + 1) / (8.0 * count * 2.0) for i in range(count)]
        )
        self.twr = np.cos(temp).astype(F32)
        self.twi = np.sin(temp).astype(F32)

    def __call__(self, buf: np.ndarray) -> np.ndarray:
        nf = self.nf
        assert buf.shape == (nf,) and buf.dtype == F32
        in_r, in_i = _cmul(self.twr, self.twi, buf[0::2], buf[nf - 1 :: -2])
        out_r, out_i = self.fft(in_r, in_i)
        cr, ci = _cmul(self.twr, self.twi, out_r, out_i)
        res = np.empty(nf, dtype=F32)
        res[0::2] = cr * F32(2.0)
        res[nf - 1 :: -2] = -ci * F32(2.0)
        return res
