"""Spectral quantization with global-gain search (reference
encoder/spectral_quantization.rs).

8-iteration bisection of the gain index against a bit-consumption estimate,
gain limitation to keep |x_q| <= 32767, quantization with +-0.375 offset, a
bit model replicating the arithmetic coder's table costs (incl. lsb_mode and
lastnz truncation), and one optional requantization after gain adjustment.
Carries nbits_offset adaptation state across frames.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import tables as T
from . import fp
from .fp import seq_sum
from .sns_enc import NBITS_SNS

F32 = np.float32


@dataclass
class QuantResult:
    gg_ind: int
    nbits_spec: int
    nbits_lsb: int
    nbits_trunc: int
    lsb_mode: bool
    rate_flag: int
    lastnz_trunc: int
    gg: np.float32


class SpectralQuantizer:
    def __init__(self, ne: int, fs_ind: int):
        self.ne = ne
        self.fs_ind = fs_ind
        self.reset_offset_old = False
        self.nbits_offset_old = F32(0.0)
        self.nbits_spec_old = 0
        self.nbits_est_old = 0

    def run(
        self,
        x_f: np.ndarray,
        x_q: np.ndarray,
        nbits: int,
        nbits_bandwidth: int,
        nbits_tns: int,
        nbits_ltpf: int,
    ) -> QuantResult:
        nbits_spec = self._bit_budget(nbits, nbits_bandwidth, nbits_tns, nbits_ltpf)

        # first global gain estimation
        nbits_offset, nbits_spec_adj, gg_off = self._estimation_params(nbits, nbits_spec)
        e = self._spectral_energy(x_f)
        gg_ind = self._gain_bisection(e, gg_off, nbits_spec_adj)
        reset_offset, gg_min, gg_ind = self._gain_limitation(x_f, gg_off, gg_ind)

        quant = self._quantize(x_f, x_q, nbits, gg_off, gg_ind, nbits_spec)

        self.nbits_offset_old = nbits_offset
        self.nbits_est_old = quant["nbits_est"]
        self.reset_offset_old = reset_offset
        self.nbits_spec_old = nbits_spec

        gg_ind, adjusted = self._gain_adjustment(gg_ind, gg_min, nbits_spec, quant["nbits_est"])
        if adjusted:
            quant = self._quantize(x_f, x_q, nbits, gg_off, gg_ind, nbits_spec)

        return QuantResult(
            gg_ind=gg_ind,
            nbits_spec=nbits_spec,
            nbits_lsb=quant["nbits_lsb"],
            nbits_trunc=quant["nbits_trunc"],
            lsb_mode=quant["lsb_mode"],
            rate_flag=quant["rate_flag"],
            lastnz_trunc=quant["lastnz_trunc"],
            gg=quant["gg"],
        )

    def _bit_budget(self, nbits, nbits_bandwidth, nbits_tns, nbits_ltpf) -> int:
        nbits_ari = int(np.ceil(fp.log2f(F32(self.ne) / F32(2.0))))
        nbits_ari += 3 if nbits <= 1280 else (4 if nbits <= 2560 else 5)
        return nbits - (nbits_bandwidth + nbits_tns + nbits_ltpf + NBITS_SNS + 8 + 3 + nbits_ari)

    def _estimation_params(self, nbits: int, nbits_spec: int):
        if self.reset_offset_old:
            nbits_offset = F32(0.0)
        else:
            prev = self.nbits_offset_old + F32(self.nbits_spec_old) - F32(self.nbits_est_old)
            nbits_offset = F32(0.8) * self.nbits_offset_old + F32(0.2) * min(
                F32(40.0), max(F32(-40.0), prev)
            )
        nbits_spec_adj = int(np.uint16(F32(nbits_spec) + nbits_offset + F32(0.5)))
        gg_off = -min(115, nbits // (10 * (self.fs_ind + 1))) - 105 - 5 * (self.fs_ind + 1)
        return nbits_offset, nbits_spec_adj, gg_off

    def _spectral_energy(self, x_f: np.ndarray) -> np.ndarray:
        n4 = self.ne // 4
        e = np.empty(n4, dtype=F32)
        eps = F32(np.finfo(np.float32).eps)
        for i in range(n4):
            x0, x1, x2, x3 = x_f[4 * i : 4 * i + 4]
            total = x0 * x0 + x1 * x1 + x2 * x2 + x3 * x3
            e[i] = F32(10.0) * fp.log10f(eps + total)
        return e

    def _gain_bisection(self, e: np.ndarray, gg_off: int, nbits_spec_adj: int) -> int:
        fac = 256
        gg_ind = 255
        # constants like 2.7 * 28.0 / 20.0 are const-folded by rustc with
        # sequential f32 rounding; runtime `e * 28.0 / 20.0` is two ops
        k28, k20 = F32(28.0), F32(20.0)
        c27 = F32(2.7) * k28 / k20
        c43 = F32(43.0) * k28 / k20
        c36 = F32(36.0) * k28 / k20
        c7 = F32(7.0) * k28 / k20
        for _ in range(8):
            fac >>= 1
            gg_ind -= fac
            tmp = F32(0.0)
            is_zero = True
            threshold = F32(gg_ind) + F32(gg_off)
            for item in e[::-1]:
                scaled = item * k28 / k20
                if scaled < threshold:
                    if not is_zero:
                        tmp = tmp + c27
                else:
                    # += groups the RHS before accumulating (Rust semantics)
                    if threshold < (scaled - c43):
                        rhs = F32(2.0) * item * k28 / k20 - F32(2.0) * threshold - c36
                    else:
                        rhs = scaled - threshold + c7
                    tmp = tmp + rhs
                    is_zero = False
            if (tmp > F32(nbits_spec_adj) * F32(1.4) * k28 / k20) and not is_zero:
                gg_ind += fac
        return gg_ind

    @staticmethod
    def _gain_limitation(x_f: np.ndarray, gg_off: int, gg_ind: int):
        x_max = F32(max(F32(0.0), np.max(np.abs(x_f)))) if len(x_f) else F32(0.0)
        if x_max > 0.0:
            gg_min = (
                int(np.ceil(F32(28.0) * fp.log10f(x_max / (F32(32768.0) - F32(0.375)))))
                - gg_off
            )
        else:
            gg_min = 0
        if gg_ind < gg_min or x_max == 0.0:
            return True, gg_min, gg_min
        return False, gg_min, gg_ind

    def _quantize(self, x_f, x_q, nbits, gg_off, gg_ind, nbits_spec):
        gg = fp.powf(F32(10.0), F32(F32(gg_ind) + F32(gg_off)) / F32(28.0))
        scaled = x_f / gg
        offs = np.where(x_f >= 0.0, scaled + F32(0.375), scaled - F32(0.375))
        # Rust `as i16` truncates toward zero and saturates
        x_q[:] = np.clip(np.trunc(offs), -32768.0, 32767.0).astype(np.int16)

        bc = self._bit_consumption(x_q, nbits, nbits_spec)
        x_q[bc["lastnz_trunc"] : bc["lastnz"]] = 0
        lsb_mode = bc["mode_flag"] and bc["nbits_est"] > nbits_spec
        bc["lsb_mode"] = lsb_mode
        bc["gg"] = gg
        return bc

    def _bit_consumption(self, x_q, nbits, nbits_spec):
        rate_flag = 512 if nbits > (160 + self.fs_ind * 160) else 0
        mode_flag = nbits >= (480 + self.fs_ind * 160)

        lastnz = self.ne
        while lastnz > 2 and x_q[lastnz - 1] == 0 and x_q[lastnz - 2] == 0:
            lastnz -= 2

        nbits_est_local = 0
        nbits_trunc_local = 0
        nbits_lsb = 0
        lastnz_trunc = 2
        c = 0
        lookup = T.AC_SPEC_LOOKUP
        bits_tab = T.AC_SPEC_BITS
        for n in range(0, lastnz, 2):
            t = c + rate_flag + (256 if n > self.ne // 2 else 0)
            a = abs(int(x_q[n]))
            a_lsb = a
            b = abs(int(x_q[n + 1]))
            b_lsb = b
            lev = 0
            while max(a, b) >= 4:
                pki = int(lookup[t + lev * 1024])
                nbits_est_local += int(bits_tab[pki][16])
                if lev == 0 and mode_flag:
                    nbits_lsb += 2
                else:
                    nbits_est_local += 2 * 2048
                a >>= 1
                b >>= 1
                lev = min(3, lev + 1)
            pki = int(lookup[t + lev * 1024])
            nbits_est_local += int(bits_tab[pki][a + 4 * b])
            if a_lsb > 0:
                nbits_est_local += 2048
            if b_lsb > 0:
                nbits_est_local += 2048
            if lev > 0 and mode_flag:
                a_lsb >>= 1
                b_lsb >>= 1
                if a_lsb == 0 and x_q[n] != 0:
                    nbits_lsb += 1
                if b_lsb == 0 and x_q[n + 1] != 0:
                    nbits_lsb += 1
            if (x_q[n] != 0 or x_q[n + 1] != 0) and int(
                np.ceil(F32(nbits_est_local) / F32(2048.0))
            ) <= nbits_spec:
                lastnz_trunc = n + 2
                nbits_trunc_local = nbits_est_local
            t = 1 + (a + b) * (lev + 1) if lev <= 1 else 12 + lev
            c = (c & 15) * 16 + t

        nbits_est = int(np.ceil(F32(nbits_est_local) / F32(2048.0))) + nbits_lsb
        nbits_trunc = int(np.ceil(F32(nbits_trunc_local) / F32(2048.0)))
        return {
            "lastnz": lastnz,
            "lastnz_trunc": lastnz_trunc,
            "nbits_est": nbits_est,
            "mode_flag": mode_flag,
            "nbits_lsb": nbits_lsb,
            "nbits_trunc": nbits_trunc,
            "rate_flag": rate_flag,
        }

    def _gain_adjustment(self, gg_ind, gg_min, nbits_spec, nbits_est):
        t1 = [80, 230, 380, 530, 680][self.fs_ind]
        t2 = [500, 1025, 1550, 2075, 2600][self.fs_ind]
        t3 = [850, 1700, 2550, 3400, 4250][self.fs_ind]

        if nbits_est < t1:
            delta = (F32(nbits_est) + F32(48.0)) / F32(16.0)
        elif nbits_est < t2:
            tmp1 = F32(t1) / F32(16.0) + F32(3.0)
            tmp2 = F32(t2) / F32(48.0)
            delta = (F32(nbits_est) - F32(t1)) * (tmp2 - tmp1) / (F32(t2) - F32(t1)) + tmp1
        elif nbits_est < t3:
            delta = F32(nbits_est) / F32(48.0)
        else:
            delta = F32(t3) / F32(48.0)
        delta = np.floor(delta + F32(0.5))
        delta2 = delta + F32(2.0)

        origin = gg_ind
        if (gg_ind < 255 and nbits_est > nbits_spec) or (
            gg_ind > 0 and F32(nbits_est) < F32(nbits_spec) - delta2
        ):
            if F32(nbits_est) < F32(nbits_spec) - delta2:
                gg_ind -= 1
            elif gg_ind == 254 or F32(nbits_est) < F32(nbits_spec) + delta:
                gg_ind += 1
            else:
                gg_ind += 2
            gg_ind = max(gg_ind, gg_min)
        return gg_ind, origin != gg_ind
