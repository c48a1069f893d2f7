"""The lc3jax_torch fused encode slice on the CPU: the bit model's emit_pack
rows, the pack kernel's plain version, its range-coder core, the fused
BatchEncoder and the frame-axis loops.

The JAX outputs come from tests/goldens/torch_pack.npz
(tools/gen_torch_pack_goldens.py): the JAX bit model's emit_pack rows on
the tuples of tests/goldens/torch_encode.npz, and the two interpret-mode
batches of tests/test_pallas_pack.py (fields and device_pack bytes). Every
comparison is of integers or bytes: the tolerance is zero. The references
of the bytes are JAX's device_pack, the port's build of the C++ host packer
(coding/host_pack.py) and the oracle (lc3jax.coding.host.pack_frames, the
numpy BitstreamEncoder).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lc3jax.coding.host import pack_frames as oracle_pack
from lc3jax.ref.bitstream_enc import BackForthWriter, BitstreamEncoder
from lc3jax_torch import _build
from lc3jax_torch.coding import host_pack
from lc3jax_torch.coding import pack_kernel as PK
from lc3jax_torch.coding.device import decode_bytes_step, encode_bytes_step
from lc3jax_torch.config import FrameDuration, Lc3Config
from lc3jax_torch.convert import (encoder_fields_from_numpy, encoder_fields_to_numpy,
                                  pack_tables_from_jax)
from lc3jax_torch.dsp import bitmodel_kernel as B
from lc3jax_torch.dsp import encoder as E
from lc3jax_torch.dsp import streaming
from lc3jax_torch.dsp.decoder import decoder_init
from lc3jax_torch.serving import BatchEncoder

ROOT = Path(__file__).resolve().parent.parent
CFG48 = Lc3Config.new(48000, FrameDuration.MS10)
CFG8 = Lc3Config.new(8000, FrameDuration.MS7P5)
CFG8_10 = Lc3Config.new(8000, FrameDuration.MS10)


@pytest.fixture(scope="module")
def gold(goldens):
    return goldens("torch_pack")


def _host_fields(fields: dict) -> dict:
    return encoder_fields_to_numpy({k: v for k, v in fields.items() if k != "quant_pack_tables"})


def _assert_bytes_equal(got, want, name):
    bad = np.flatnonzero((np.asarray(got) != np.asarray(want)).any(1))
    assert bad.size == 0, f"{name}: streams {bad[:8].tolist()} differ"


# --------------------------------------------------------------- bit model


@pytest.mark.parametrize("nbits", [320, 1200])
def test_bitmodel_emit_pack_equals_jax(goldens, gold, nbits):
    """The plain emit_pack rows equal JAX's on each stream's own tuples
    (JAX's pad rows dropped), hold 0 past them, and leave the table part
    as it is without emit_pack."""
    bm = goldens("torch_encode")
    t = lambda k: torch.as_tensor(bm[f"bm_{k}"].astype(np.int32))  # noqa: E731
    rate = 512 if nbits > 160 + CFG48.fs_ind * 160 else 0
    args = (t("c"), t("g"), t("sym"), rate, CFG48.ne, t("lastnz"))
    est, pk = B.bitmodel_table_part_plain(*args, emit_pack=True)
    assert torch.equal(est, B.bitmodel_table_part_plain(*args))
    want = pack_tables_from_jax(gold[f"bm_pk_{nbits}"], CFG48.ne)
    NT = CFG48.ne // 2
    own = np.arange(NT)[:, None] < ((bm["bm_lastnz"] + 1) >> 1)[None, :]  # [NT, S]
    own = np.tile(own, (5, 1))
    got = pk.numpy()
    assert got.shape == want.shape == (5 * NT, bm["bm_c"].shape[0])
    assert np.array_equal(got[own], want[own])
    assert (got[~own] == 0).all() and (want[~own] != 0).any()


# -------------------------------------------------------------------- pack


@pytest.mark.parametrize("tag,nbytes", [("mixed", 40), ("lsb", 80)])
def test_device_pack_plain_equals_jax_host_and_oracle(gold, tag, nbytes):
    """S = 128 at 8 kHz / 7.5 ms, the JAX step's fields carried across:
    the plain pack equals JAX's interpret-mode device_pack, the port's host
    packer and the oracle, byte for byte."""
    d = {k[len(tag) + 3:]: gold[k] for k in gold.files if k.startswith(f"{tag}_f_")}
    fields = encoder_fields_from_numpy(d)
    assert fields["quant_pack_tables"].shape == (5 * (CFG8.ne // 2), 128)
    before = _build.launches.copy()
    got, stats = PK.device_pack_plain(CFG8, nbytes, fields, stats=True)
    assert torch.equal(PK.device_pack(CFG8, nbytes, fields), got) and _build.launches == before
    got = got.numpy()
    _assert_bytes_equal(got, gold[f"{tag}_bytes"], "JAX device_pack")
    _assert_bytes_equal(got, host_pack.pack_frames(CFG8, _host_fields(fields), nbytes), "host")
    oracle = np.frombuffer(b"".join(oracle_pack(CFG8, _host_fields(fields), nbytes)), np.uint8)
    _assert_bytes_equal(got, oracle.reshape(-1, nbytes), "oracle")
    assert int(stats["carry"].sum()) > 0
    if tag == "lsb":
        assert int(stats["lsb_mode"].sum()) > 0


def test_device_pack_plain_lsb_noise_48k():
    """Full-scale noise at 48 kHz / 150 B through the port's own encode step
    (S = 8, second frame): every frame in LSB mode, the plain pack equal to
    the host packer and the oracle (JAX's device_pack needs S % 128 == 0)."""
    rng = np.random.default_rng(12)
    pcm = np.clip(rng.standard_normal((2, 8, CFG48.nf)) * 28000, -32768, 32767).astype(np.int16)
    st = E.encoder_init(CFG48, 8, device="cpu")
    for t in range(2):
        st, fields = E.encode_step(CFG48, 150, st, torch.as_tensor(pcm[t]), emit_pack=True)
    got, stats = PK.device_pack_plain(CFG48, 150, fields, stats=True)
    assert bool(stats["lsb_mode"].all())
    host = _host_fields(fields)
    _assert_bytes_equal(got.numpy(), host_pack.pack_frames(CFG48, host, 150), "host")
    oracle = np.frombuffer(b"".join(oracle_pack(CFG48, host, 150)), np.uint8).reshape(8, 150)
    _assert_bytes_equal(got.numpy(), oracle, "oracle")


def test_emit_pack_leaves_the_fields_alone():
    """encode_step with emit_pack adds quant_pack_tables and changes no
    other field; without it the fields are the host-pack mode's."""
    rng = np.random.default_rng(3)
    pcm = torch.as_tensor(rng.normal(0, 3000, (2, CFG8_10.nf)).astype(np.int16))
    _, plain = E.encode_step(CFG8_10, 40, E.encoder_init(CFG8_10, 2, device="cpu"), pcm)
    _, emit = E.encode_step(CFG8_10, 40, E.encoder_init(CFG8_10, 2, device="cpu"), pcm,
                            emit_pack=True)
    assert set(emit) - set(plain) == {"quant_pack_tables"}
    for k, v in plain.items():
        assert (torch.equal(v, emit[k]) if isinstance(v, torch.Tensor) else v == emit[k]), k
    back = encoder_fields_from_numpy(encoder_fields_to_numpy(emit))
    for k, v in emit.items():
        w = back[k]
        assert (v.dtype == w.dtype and torch.equal(v, w)) if isinstance(v, torch.Tensor) else v == w


def test_device_pack_wrapper_refuses_other_devices(gold):
    d = {k[8:]: gold[k] for k in gold.files if k.startswith("mixed_f_")}
    fields = encoder_fields_from_numpy(d)
    with pytest.raises(ValueError, match="unsupported device"):
        PK.device_pack(CFG8, 40, {k: v.to("meta") if isinstance(v, torch.Tensor) else v
                                  for k, v in fields.items()})
    with pytest.raises(ValueError, match="emit_pack=True"):
        PK.device_pack(CFG8, 40, {k: v for k, v in fields.items() if k != "quant_pack_tables"})


# --------------------------------------------------------- range-coder core


def _oracle_coder():
    enc = BitstreamEncoder(ne=2)
    enc.w = BackForthWriter(600)
    enc.low, enc.range, enc.cache, enc.carry, enc.carry_count = 0, 0x00FFFFFF, -1, 0, 0
    return enc


def _run_lockstep(sources, n_sym):
    """One oracle coder per lane and the plain core over all lanes, in
    lockstep: each symbol source sees its own oracle's live (low, range).
    Returns the core and the carried groups' runs of pending bytes."""
    S = len(sources)
    encs = [_oracle_coder() for _ in range(S)]
    core = PK.RangeEncoderLanes(S, 600, "cpu")
    on = torch.ones(S, dtype=torch.bool)
    for i in range(n_sym):
        syms = [src(i, e.low, e.range) for src, e in zip(sources, encs)]
        for e, (cum, frq) in zip(encs, syms):
            e._ac_encode(cum, frq)
        core.encode(torch.tensor([c for c, _ in syms]), torch.tensor([f for _, f in syms]), on)
        assert core.low.tolist() == [e.low for e in encs], f"low @ {i}"
        assert core.rng.tolist() == [e.range for e in encs], f"range @ {i}"
    head, _ = core.finish()
    runs = []
    for s, e in enumerate(encs):
        e._ac_finish()
        want = bytes(e.w.buf[: e.w.bp + 1])  # the final partial byte sits at bp
        assert bytes(head[s, : len(want)].tolist()) == want, s
        assert int(core.bp[s]) == len(want)
        starts = np.flatnonzero(core.starts[s, :600].numpy())
        ends = np.flatnonzero(core.ends[s, :600].numpy())
        headless = bool(core.hl0[s]) and starts.size and starts[0] == 0
        runs += [int(b - a) - (0 if (headless and a == 0) else 1) for a, b in zip(starts, ends)]
    return core, runs


def test_range_coder_core_chained_ff():
    """low steered onto 0xFFxxxx at every renorm chains pending bytes, then
    an overflow carries into them: +1 at the cache byte, 0 over the run."""

    def steer(i, low, range_):
        r = range_ >> 10
        if i % 7 == 6:
            return 1023, 1
        return int(min(1023, max(0, (0xFFFF80 - low) // max(r, 1)))), 4

    _, runs = _run_lockstep([steer], 160)
    assert max(runs) >= 3, f"adversarial stream too shallow (pending run {max(runs)})"


def test_range_coder_core_headless_group():
    """Pending bytes before any cache byte exists: the reference skips the
    cache write, so the carry zeroes the run without a +1."""

    def steer(i, low, range_):
        if i < 3:
            return 1023, 4
        return (i * 97) % 900, 3 + (i % 60)

    core, _ = _run_lockstep([steer], 80)
    assert bool(core.hl0[0]), "headless-group path not exercised"


def test_range_coder_core_random_streams():
    def source(seed):
        rng = np.random.default_rng(seed)

        def rand(i, low, range_):
            cum = int(rng.integers(0, 1000))
            return cum, int(rng.integers(1, 1025 - cum))
        return rand

    _run_lockstep([source(seed) for seed in range(8)], 200)


# ---------------------------------------------------------------- the slice


def test_batch_encoder_device_pack_equals_oracle_and_host_pack(goldens):
    """BatchEncoder(device_pack=True) on the CPU: the first frames of
    stream50 (120 B) and of the corpus' 8 kHz / 10 ms / 40 B equal the
    oracle's payloads and the host-pack mode frame for frame; then nbytes
    changes mid-stream with the state kept, still equal to the host-pack
    mode."""
    s50, corpus = goldens("stream50"), goldens("corpus")
    cases = [(CFG48, s50["pcm_in"], s50["payloads"], [120] * 4 + [60, 150, 40]),
             (CFG8_10, corpus["8000_10ms_40_pcm_in"], corpus["8000_10ms_40_payloads"], [40] * 5)]
    for cfg, pcm, want, plan in cases:
        fused = BatchEncoder(cfg, 1, plan[0], device="cpu", device_pack=True)
        host = BatchEncoder(cfg, 1, plan[0], device="cpu")
        for f, nb in enumerate(plan):
            got = fused.encode(pcm[f : f + 1], nbytes=nb)
            assert got.shape == (1, nb) and got.dtype == np.uint8
            assert np.array_equal(got, host.encode(pcm[f : f + 1], nbytes=nb)), (cfg.fs, f, nb)
            if nb == plan[0]:
                assert np.array_equal(got[0], want[f]), (cfg.fs, f)
        assert fused.metrics.snapshot()["frames_encoded"] == len(plan)
    with pytest.raises(ValueError, match="device_pack=True"):
        host.encode_tensor(torch.zeros(1, CFG8_10.nf, dtype=torch.int16))


def test_streaming_loops_equal_their_steps(goldens):
    """encode_bytes_frames over T = 3 equals three encode_bytes_step calls,
    decode_bytes_frames three decode_bytes_step calls (S = 2, 8 kHz /
    10 ms / 40 B); encode_frames stacks encode_step's fields."""
    g = goldens("corpus")
    pcm = torch.as_tensor(g["8000_10ms_40_pcm_in"][:6].reshape(2, 3, -1).transpose(1, 0, 2).copy())
    st, out = streaming.make_encode_bytes_frames(CFG8_10, 40, device="cpu")(
        E.encoder_init(CFG8_10, 2, device="cpu"), pcm)
    st2 = E.encoder_init(CFG8_10, 2, device="cpu")
    for t in range(3):
        st2, b = encode_bytes_step(CFG8_10, 40, st2, pcm[t])
        assert torch.equal(out[t], b), t
    assert torch.equal(st.time_buf, st2.time_buf)
    _, fields = streaming.encode_frames(CFG8_10, 40, E.encoder_init(CFG8_10, 2, device="cpu"), pcm)
    assert fields["x_q"].shape == (3, 2, CFG8_10.ne) and fields["nbits_bw"] == 0

    dst, pcm_out = streaming.decode_bytes_frames(
        CFG8_10, 40, decoder_init(CFG8_10, 2, device="cpu"), out)
    dst2 = decoder_init(CFG8_10, 2, device="cpu")
    for t in range(3):
        dst2, p = decode_bytes_step(CFG8_10, 40, dst2, out[t])
        assert torch.equal(pcm_out[t], p), t
    assert torch.equal(dst.mem_ola, dst2.mem_ola)


# ---------------------------------------------------------------- the build


_EXTERN = re.compile(r'extern "C" int (lc3t_\w+)\((.*?)\)\s*\{', re.S)


def test_build_signatures_match_the_sources():
    """Each ctypes declaration in _build.SIGNATURES has as many arguments as
    its extern "C" definition in csrc/*.cu, and every entry has one."""
    found = {}
    for src in sorted((ROOT / "lc3jax_torch" / "csrc").glob("*.cu")):
        for name, args in _EXTERN.findall(src.read_text()):
            found[name] = len([a for a in args.split(",") if a.strip()])
    assert set(found) == set(_build.SIGNATURES), set(found) ^ set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert len(argtypes) == found[name], (name, len(argtypes), found[name])
