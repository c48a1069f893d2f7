"""Bit-exact DCT-IV for the encoder's MDCT: the oracle's kissfft stages,
batched over streams (port of lc3jax/dsp/fftexact.py).

A dense-matmul DCT-IV accumulates in another order than the reference's
kissfft recursion (common/kissfft.rs, common/dct_iv.rs:49-67), and a few
frames then land on the other side of the quantizer's +-0.375 knife edge.
This module evaluates the same butterfly decomposition, every f32 multiply
and add in the same order, vectorised over streams and butterfly segments
(per-element ops are independent, so each rounding is preserved).

Eager PyTorch rounds every op on its own and never fuses a multiply into a
later add, on the CPU and on CUDA alike, so no contraction guard is needed.
Plain PyTorch on the card: there is no TPU kernel here to port.

Per transform of length nfft = nf/2 (radices all in {2, 3, 4, 5}):
  1. leaf permutation: the recursion's strided input gather is a
     mixed-radix digit reversal, one static index_select;
  2. butterfly stages, deepest first: at stage s with (p, m) the segments
     tile the array, so one reshape to [S, nseg, p, m] vectorises it;
  3. the DCT-IV pre/post twiddles and the even/odd re-interleave.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

F32 = np.float32


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


def _leaf_permutation(nfft: int, factors: list[tuple[int, int]]) -> np.ndarray:
    """Input index for each leaf output position of the kissfft recursion."""
    perm = np.zeros(nfft, dtype=np.int64)

    def work(fstride: int, stage: int, fin_idx: int, fout_idx: int) -> None:
        p, m = factors[stage]
        if m == 1:
            perm[fout_idx : fout_idx + p] = fin_idx + fstride * np.arange(p)
            return
        end = fout_idx + p * m
        while fout_idx != end:
            work(fstride * p, stage + 1, fin_idx, fout_idx)
            fin_idx += fstride
            fout_idx += m

    work(1, 0, 0, 0)
    return perm


class _Consts:
    """Per-device tensors of one transform length, made on first use."""

    def __init__(self, arrays: dict, device):
        for k, v in arrays.items():
            setattr(self, k, torch.as_tensor(v, device=device))


class BatchedFaithfulFFT:
    """Forward complex FFT on [S, nfft] rows, bit-identical per row to the
    reference's f32 kissfft."""

    def __init__(self, nfft: int):
        self.nfft = nfft
        phase = np.array([-2.0 * math.pi * i / nfft for i in range(nfft)])
        self.twr = np.cos(phase).astype(F32)
        self.twi = np.sin(phase).astype(F32)
        self.factors = _factorize(nfft)
        assert all(p in (2, 3, 4, 5) for p, _ in self.factors), (
            "generic-radix butterflies are not needed for LC3 sizes"
        )
        self.perm = _leaf_permutation(nfft, self.factors)
        self.fstrides = []
        fs = 1
        for p, _ in self.factors:
            self.fstrides.append(fs)
            fs *= p
        self._dev: dict = {}

    def _tw(self, step: int, m: int, dev):
        key = (step, m, dev)
        if key not in self._dev:
            idx = step * np.arange(m)
            self._dev[key] = (torch.as_tensor(self.twr[idx], device=dev),
                              torch.as_tensor(self.twi[idx], device=dev))
        return self._dev[key]

    def _perm(self, dev):
        key = ("perm", dev)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.perm, device=dev)
        return self._dev[key]

    def __call__(self, fin_r: torch.Tensor, fin_i: torch.Tensor):
        dev = fin_r.device
        perm = self._perm(dev)
        fr = fin_r.index_select(1, perm)
        fi = fin_i.index_select(1, perm)
        S = fr.shape[0]
        for s in range(len(self.factors) - 1, -1, -1):
            p, m = self.factors[s]
            fstride = self.fstrides[s]
            nseg = self.nfft // (p * m)
            r4 = fr.reshape(S, nseg, p, m)
            i4 = fi.reshape(S, nseg, p, m)
            br = [r4[:, :, j, :] for j in range(p)]
            bi = [i4[:, :, j, :] for j in range(p)]
            bfly = {2: self._bfly2, 3: self._bfly3, 4: self._bfly4, 5: self._bfly5}[p]
            outr, outi = bfly(br, bi, fstride, m, dev)
            fr = torch.stack(outr, dim=2).reshape(S, self.nfft)
            fi = torch.stack(outi, dim=2).reshape(S, self.nfft)
        return fr, fi

    # Each bfly mirrors the same-named method of lc3jax/ref/fft.py op by op.

    def _bfly2(self, fr, fi, fstride, m, dev):
        twr, twi = self._tw(fstride, m, dev)
        tr = fr[1] * twr - fi[1] * twi
        ti = fr[1] * twi + fi[1] * twr
        return ([fr[0] + tr, fr[0] - tr], [fi[0] + ti, fi[0] - ti])

    def _bfly4(self, fr, fi, fstride, m, dev):
        t1r, t1i = self._tw(fstride, m, dev)
        t2r, t2i = self._tw(fstride * 2, m, dev)
        t3r, t3i = self._tw(fstride * 3, m, dev)
        s0r = fr[1] * t1r - fi[1] * t1i
        s0i = fr[1] * t1i + fi[1] * t1r
        s1r = fr[2] * t2r - fi[2] * t2i
        s1i = fr[2] * t2i + fi[2] * t2r
        s2r = fr[3] * t3r - fi[3] * t3i
        s2i = fr[3] * t3i + fi[3] * t3r
        s5r = fr[0] - s1r
        s5i = fi[0] - s1i
        f0r = fr[0] + s1r
        f0i = fi[0] + s1i
        s3r = s0r + s2r
        s3i = s0i + s2i
        s4r = s0r - s2r
        s4i = s0i - s2i
        f2r = f0r - s3r
        f2i = f0i - s3i
        f0r = f0r + s3r
        f0i = f0i + s3i
        # forward-transform branch of kissfft.rs:169-170
        f1r = s5r + s4i
        f1i = s5i - s4r
        f3r = s5r - s4i
        f3i = s5i + s4r
        return ([f0r, f1r, f2r, f3r], [f0i, f1i, f2i, f3i])

    def _bfly3(self, fr, fi, fstride, m, dev):
        epi3_i = float(self.twi[fstride * m])
        t1r, t1i = self._tw(fstride, m, dev)
        t2r, t2i = self._tw(fstride * 2, m, dev)
        s1r = fr[1] * t1r - fi[1] * t1i
        s1i = fr[1] * t1i + fi[1] * t1r
        s2r = fr[2] * t2r - fi[2] * t2i
        s2i = fr[2] * t2i + fi[2] * t2r
        s3r = s1r + s2r
        s3i = s1i + s2i
        s0r = s1r - s2r
        s0i = s1i - s2i
        fmr = fr[0] - s3r * 0.5
        fmi = fi[0] - s3i * 0.5
        s0r = s0r * epi3_i
        s0i = s0i * epi3_i
        f0r = fr[0] + s3r
        f0i = fi[0] + s3i
        f2r = fmr + s0i
        f2i = fmi - s0r
        f1r = fmr - s0i
        f1i = fmi + s0r
        return ([f0r, f1r, f2r], [f0i, f1i, f2i])

    def _bfly5(self, fr, fi, fstride, m, dev):
        ya_r, ya_i = float(self.twr[fstride * m]), float(self.twi[fstride * m])
        yb_r, yb_i = float(self.twr[fstride * 2 * m]), float(self.twi[fstride * 2 * m])
        t1r, t1i = self._tw(fstride, m, dev)
        t2r, t2i = self._tw(fstride * 2, m, dev)
        t3r, t3i = self._tw(fstride * 3, m, dev)
        t4r, t4i = self._tw(fstride * 4, m, dev)
        s0r, s0i = fr[0], fi[0]
        s1r = fr[1] * t1r - fi[1] * t1i
        s1i = fr[1] * t1i + fi[1] * t1r
        s2r = fr[2] * t2r - fi[2] * t2i
        s2i = fr[2] * t2i + fi[2] * t2r
        s3r = fr[3] * t3r - fi[3] * t3i
        s3i = fr[3] * t3i + fi[3] * t3r
        s4r = fr[4] * t4r - fi[4] * t4i
        s4i = fr[4] * t4i + fi[4] * t4r
        s7r, s7i = s1r + s4r, s1i + s4i
        s10r, s10i = s1r - s4r, s1i - s4i
        s8r, s8i = s2r + s3r, s2i + s3i
        s9r, s9i = s2r - s3r, s2i - s3i
        f0r = fr[0] + (s7r + s8r)
        f0i = fi[0] + (s7i + s8i)
        s5r = s0r + s7r * ya_r + s8r * yb_r
        s5i = s0i + s7i * ya_r + s8i * yb_r
        s6r = s10i * ya_i + s9i * yb_i
        s6i = -(s10r * ya_i) - s9r * yb_i
        f1r = s5r - s6r
        f1i = s5i - s6i
        f4r = s5r + s6r
        f4i = s5i + s6i
        s11r = s0r + s7r * yb_r + s8r * ya_r
        s11i = s0i + s7i * yb_r + s8i * ya_r
        s12r = -(s10i * yb_i) + s9i * ya_i
        s12i = s10r * yb_i - s9r * ya_i
        f2r = s11r + s12r
        f2i = s11i + s12i
        f3r = s11r - s12r
        f3i = s11i - s12i
        return ([f0r, f1r, f2r, f3r, f4r], [f0i, f1i, f2i, f3i, f4i])


class BatchedFaithfulDctIV:
    """DCT-IV on [S, nf] rows, bit-identical per row to the oracle's
    FaithfulDctIV (dct_iv.rs:49-67)."""

    def __init__(self, nf: int):
        self.nf = nf
        count = nf // 2
        self.fft = BatchedFaithfulFFT(count)
        temp = np.array([-math.pi * (8 * i + 1) / (8.0 * count * 2.0) for i in range(count)])
        self.twr = np.cos(temp).astype(F32)
        self.twi = np.sin(temp).astype(F32)
        # res[0::2] = even path, res[nf-1::-2] = odd path (reversed)
        inv = np.zeros(nf, dtype=np.int64)
        inv[np.arange(0, nf, 2)] = np.arange(count)
        inv[np.arange(nf - 1, -1, -2)] = count + np.arange(count)
        self.out_perm = inv
        self.odd = np.arange(nf - 1, -1, -2)
        self._dev: dict = {}

    def _consts(self, dev):
        if dev not in self._dev:
            self._dev[dev] = _Consts(dict(twr=self.twr, twi=self.twi, out_perm=self.out_perm,
                                          odd=self.odd), dev)
        return self._dev[dev]

    def __call__(self, buf: torch.Tensor) -> torch.Tensor:
        c = self._consts(buf.device)
        be = buf[:, 0::2]
        bo = buf.index_select(1, c.odd)
        in_r = c.twr * be - c.twi * bo
        in_i = c.twr * bo + c.twi * be
        out_r, out_i = self.fft(in_r, in_i)
        cr = c.twr * out_r - c.twi * out_i
        ci = c.twr * out_i + c.twi * out_r
        halves = torch.cat([cr * 2.0, -(ci * 2.0)], dim=1)
        return halves.index_select(1, c.out_perm)


@lru_cache(maxsize=None)
def batched_dct_iv(nf: int) -> BatchedFaithfulDctIV:
    return BatchedFaithfulDctIV(nf)
