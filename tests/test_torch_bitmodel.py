"""lc3jax_torch spectral bit model (the table part and the whole
bit_consumption) against the JAX package.

The JAX outputs come from tests/goldens/torch_encode.npz
(tools/gen_torch_encode_goldens.py): `bitmodel_table_part` in interpret
mode and `bit_consumption` through its XLA path, on the tuples of 128
random quantized spectra with ragged last nonzero lines, at 48 kHz / 10 ms
with 320 and 1200 frame bits (rate flag 0 and 512). Everything is exact
integers: the tolerance is zero.

The Pallas kernel computes every tuple up to the batch's largest lastnz;
the port computes each stream's own tuples and writes 0 past them. The
tail masks those tuples either way, so the table part is compared on each
stream's own tuples and bit_consumption on everything it returns.
"""

import numpy as np
import pytest
import torch

from lc3jax_torch import _build
from lc3jax_torch import tables as T
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.convert import encoder_tables
from lc3jax_torch.dsp import bitmodel_kernel as B
from lc3jax_torch.dsp import encoder as E

CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
NBITS = [320, 1200]


@pytest.fixture(scope="module")
def gold(goldens):
    g = goldens("torch_encode")
    return {k[3:]: g[k] for k in g.files if k.startswith("bm_")}


def _rate_flag(nbits):
    return 512 if nbits > 160 + CFG48.fs_ind * 160 else 0


def _table_args(gold, nbits):
    t = lambda k: torch.as_tensor(gold[k])
    return t("c"), t("g"), t("sym"), _rate_flag(nbits), CFG48.ne, t("lastnz")


def test_tuple_symbols_equal_jax_derivation(gold):
    ts = E.tuple_symbols(torch.as_tensor(gold["x_q"].astype(np.int32)))
    for k in ("c", "g", "sym", "lastnz"):
        assert ts[k].dtype == torch.int32, k  # the widths the kernel reads
        assert np.array_equal(ts[k].numpy(), gold[k].astype(np.int64)), k


@pytest.mark.parametrize("nbits", NBITS)
def test_bitmodel_plain_equals_pallas_kernel(gold, nbits):
    got = B.bitmodel_table_part_plain(*_table_args(gold, nbits)).numpy()
    want = gold[f"table_{nbits}"]
    own = np.arange(got.shape[1])[None, :] < ((gold["lastnz"] + 1) >> 1)[:, None]
    assert np.array_equal(got[own], want[own])
    assert (got[~own] == 0).all() and (want[~own] != 0).any()


@pytest.mark.parametrize("nbits", NBITS)
def test_bit_consumption_equals_jax(gold, nbits):
    x_q = torch.as_tensor(gold["x_q"].astype(np.int32))
    nbits_spec = torch.full((x_q.shape[0],), nbits - 300, dtype=torch.int32)
    bc = E.bit_consumption(encoder_tables(CFG48, nbits), x_q, nbits, nbits_spec)
    for k in ("lastnz", "lastnz_trunc", "nbits_est", "nbits_trunc", "nbits_lsb"):
        assert np.array_equal(bc[k].numpy(), gold[f"bc_{nbits}_{k}"]), k


def test_bitmodel_wrapper_takes_plain_for_cpu_and_refuses_other_devices(gold):
    args = _table_args(gold, 1200)
    before = _build.launches.copy()
    assert torch.equal(B.bitmodel_table_part(*args), B.bitmodel_table_part_plain(*args))
    assert _build.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        B.bitmodel_table_part(args[0].to("meta"), *args[1:])


def _composed_lookup(tab, c, g, sym, ne, lastnz, emit_pack):
    """The CUDA kernel's lookups, in plain torch, through its precomposed
    tables tab (bitmodel_kernel.compose_tables)."""
    NT = c.shape[1]
    n = torch.arange(NT)
    base = torch.where(n > ne // 4, 1024, 0)[None, :] + c.long()
    w = [tab[B.ESC_WORD + base + 256 * L].long() for L in range(4)]
    G = g.long()
    est = (torch.where(G > 0, w[0] >> 6, 0) + torch.where(G > 1, w[1] >> 6, 0)
           + torch.where(G > 2, w[2] >> 6, 0) + torch.where(G > 3, (G - 3) * (w[3] >> 6), 0))
    wl = torch.where(G == 0, w[0], torch.where(G == 1, w[1], torch.where(G == 2, w[2], w[3])))
    f = 17 * (wl & 63) + sym.long()
    est = est + tab[B.SYM_COST + f]
    coded = n[None, :] < ((lastnz.long() + 1) >> 1)[:, None]
    est = torch.where(coded, est, 0).to(torch.int32)
    if not emit_pack:
        return est
    rows = [tab[B.ESC_OP + base + 256 * L] for L in range(4)] + [tab[B.SYM_OP + f]]
    return est, torch.cat([torch.where(coded, r, 0).t() for r in rows]).to(torch.int32).contiguous()


def _every_context_tuples(ne=400):
    """Tuples that reach every (hi, L, c) with every final symbol: for hi = 0
    the columns n <= ne / 4, for hi = 1 the rest; ladder depth L for L < 3,
    3..14 for L = 3. Returns c, g, sym [S, ne / 2] and lastnz [S] (= ne)."""
    NT, ne4 = ne // 2, ne // 4
    combos = np.array([(L, c, s) for L in range(4) for c in range(256) for s in range(17)])
    cols = {0: np.arange(ne4 + 1), 1: np.arange(ne4 + 1, NT)}
    S = max(-(-len(combos) // len(v)) for v in cols.values())
    c, g, sym = (np.zeros((S, NT), np.int32) for _ in range(3))
    rng = np.random.default_rng(11)
    for hi, col in cols.items():
        k = np.arange(S * len(col)) % len(combos)
        L, cv, sv = combos[k].T
        depth = np.where(L < 3, L, rng.integers(3, 15, k.size))
        for a, v in ((c, cv), (g, depth), (sym, sv)):
            a[:, col] = v.reshape(S, len(col))
    return c, g, sym, np.full(S, ne, np.int32)


@pytest.mark.parametrize("rate_flag", [0, 512])
def test_composed_tables_give_the_plain_bit_model(gold, rate_flag):
    """The CUDA kernel's precomposed tables for each rate flag, looked up in
    plain torch, give bitmodel_table_part_plain's outputs exactly, in both
    modes: entry by entry over every (hi, L, c) and (pki, sym), on tuples that
    reach every (hi, L, c) with every symbol, and on the golden tuples."""
    tab = torch.as_tensor(B.compose_tables(rate_flag))
    lut = np.asarray(T.AC_SPEC_LOOKUP, np.int64)
    bits = np.asarray(T.AC_SPEC_BITS, np.int64)
    op = np.asarray(T.AC_SPEC_CUMFREQ, np.int64) + 1024 * np.asarray(T.AC_SPEC_FREQ, np.int64)
    t = tab.numpy().astype(np.int64)
    for hi in range(2):
        for L in range(4):
            at = (hi * 4 + L) * 256 + np.arange(256)
            pki = lut[np.arange(256) + rate_flag + 256 * hi + 1024 * L]
            assert np.array_equal(t[B.ESC_WORD + at] & 63, pki)
            assert np.array_equal(t[B.ESC_WORD + at] >> 6, bits[pki, 16])
            assert np.array_equal(t[B.ESC_OP + at], op[pki, 16])
    assert np.array_equal(t[B.SYM_COST:B.SYM_COST + 64 * 17], bits.ravel())
    assert np.array_equal(t[B.SYM_OP:B.SYM_OP + 64 * 17], op.ravel())

    c, g, sym, lastnz = (torch.as_tensor(a) for a in _every_context_tuples())
    cases = [(c, g, sym, 400, lastnz),
             (*(torch.as_tensor(gold[k]) for k in ("c", "g", "sym")), CFG48.ne,
              torch.as_tensor(gold["lastnz"]))]
    for cc, gg, ss, ne, lnz in cases:
        for emit in (False, True):
            got = _composed_lookup(tab, cc, gg, ss, ne, lnz, emit)
            want = B.bitmodel_table_part_plain(cc, gg, ss, rate_flag, ne, lnz, emit_pack=emit)
            for a, b in zip(got if emit else (got,), want if emit else (want,)):
                assert a.dtype == b.dtype and torch.equal(a, b)
