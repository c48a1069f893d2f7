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
    before = B.launches
    assert torch.equal(B.bitmodel_table_part(*args), B.bitmodel_table_part_plain(*args))
    assert B.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        B.bitmodel_table_part(args[0].to("meta"), *args[1:])
