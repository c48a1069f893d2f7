"""lc3jax_torch against the oracle on the config-parity streams, on the CPU.

The frames and PCM are the oracle's (lc3jax.ref), stored in
tests/goldens/torch_config_parity.npz by tools/gen_torch_config_parity.py;
chip_smoke.py runs every stream of that file on the card. Here two of them,
6 frames each, through the port's plain path with no JAX compiled: 8 kHz /
7.5 ms / 30 B, the only 60-band geometry, and the 32 kHz / 7.5 ms / 80 B
click train, which trips the attack detector. Encoded frames byte-exact in
both encode modes, decoded PCM within 1 LSB of the oracle's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.dsp import encoder as E
from lc3jax_torch.serving import BatchDecoder, BatchEncoder

FRAMES = 6
CASES = {"8000_7.5ms_30": (8000, FrameDuration.MS7P5, 30),
         "attack_32000_7.5ms_80": (32000, FrameDuration.MS7P5, 80)}


@pytest.fixture(scope="module")
def gold(goldens):
    return goldens("torch_config_parity")


@pytest.mark.parametrize("key", CASES)
def test_decode_within_one_lsb(gold, key):
    fs, dur, nbytes = CASES[key]
    dec = BatchDecoder(Lc3Config.new(fs, dur), 1, nbytes, device="cpu")
    payloads, want = gold[f"{key}_payloads"], gold[f"{key}_pcm_out"]
    got = np.stack([dec.decode(payloads[f : f + 1])[0] for f in range(FRAMES)])
    assert np.abs(got.astype(int) - want[:FRAMES]).max() <= 1


@pytest.mark.parametrize("device_pack", [False, True], ids=["host-pack", "fused"])
@pytest.mark.parametrize("key", CASES)
def test_encode_byte_exact(gold, key, device_pack):
    fs, dur, nbytes = CASES[key]
    enc = BatchEncoder(Lc3Config.new(fs, dur), 1, nbytes, device="cpu", device_pack=device_pack)
    pcm, want = gold[f"{key}_pcm_in"], gold[f"{key}_payloads"]
    got = np.stack([enc.encode(pcm[f : f + 1])[0] for f in range(FRAMES)])
    assert np.array_equal(got, want[:FRAMES])


def test_click_train_trips_the_attack_detector(gold):
    """The 32 kHz stream's first FRAMES frames reach the port's attack branch."""
    fs, dur, nbytes = CASES["attack_32000_7.5ms_80"]
    cfg = Lc3Config.new(fs, dur)
    p, st = E.encoder_params(cfg), E.encoder_init(cfg, 1, device="cpu")
    fired = 0
    for frame in gold["attack_32000_7.5ms_80_pcm_in"][:FRAMES]:
        attack, att = E.attack_detect(p, st, torch.as_tensor(frame[None]), nbytes)
        st = dataclasses.replace(st, **att)
        fired += int(attack[0])
    assert fired >= 1
