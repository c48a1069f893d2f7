"""lc3jax_torch encoder gain estimate: the wrapper and its plain version on
the CPU, the plain version against the oracle's scalar bisection; the
kernel against its plain version on the card, alone and inside the
replayed encode steps.

The plain version (encoder.gain_bisection_plain) is held here to the
oracle (lc3jax/ref/quant.py:_gain_bisection) stream by stream on energy
rows at the fold's edges, and with the rest of the encoder by the
encoder's tests; the kernel is held to it bit for bit (`torch.equal`). The
tests marked `card` need a CUDA card and skip without one; this file
imports no JAX (the oracle's numpy module only inside the CPU test that
reads it), so on a machine with a card and without JAX it runs from the
repository's root as

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_gain_estimate.py
"""

import numpy as np
import pytest
import torch

from lc3jax_torch import _build, fp
from lc3jax_torch.config import ALL_CONFIGS
from lc3jax_torch.convert import encoder_tables
from lc3jax_torch.dsp import encoder as E
from lc3jax_torch.dsp import gain_kernel as K
from lc3jax_torch.serving import BatchEncoder

CFG_IDS = [f"{c.fs}-{c.n_ms.value}" for c in ALL_CONFIGS]
NBYTES = (20, 150)
CASES = [(c, nb) for c in ALL_CONFIGS for nb in NBYTES]
CASE_IDS = [f"{i}-{nb}B" for i in CFG_IDS for nb in NBYTES]
# the gain indices whose thresholds the edge rows sit on: 127, which the
# bisection tests first, then those it may test second and third
EDGE_INDICES = (127, 63, 191, 31, 95, 159, 223)
LOW_DB = -400.0  # below any frame's energy (10 log10(eps) = -69.2 dB): above no threshold


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _energies(x_f: torch.Tensor) -> torch.Tensor:
    """The encoder's 4-line energies of a spectrum (spectral_quantize)."""
    S, ne = x_f.shape
    sq = x_f.reshape(S, ne // 4, 4)
    sq = sq * sq
    total4 = ((sq[:, :, 0] + sq[:, :, 1]) + sq[:, :, 2]) + sq[:, :, 3]
    return 10.0 * fp.log10f(E.EPS + total4)


def _scaled(e, divisor):
    return e * 28.0 / divisor


def _edge(e, thr: float, divisor, far: bool):
    """Which energies' scaled values land exactly on the threshold (sc ==
    thr), or on its far edge (sc - c43 == thr)."""
    sc = _scaled(e, divisor)
    return (sc - K.C43 == thr) if far else (sc == thr)


def _on_edge(thr: float, divisor, far: bool):
    """An f32 energy on the threshold or its far edge, from the nearest f32
    values on both sides of the real one; None where no f32 energy lands
    there (past sc = 64 the far edge falls between two f32 values)."""
    up = down = torch.tensor((thr + K.C43 if far else thr) / 1.4, dtype=torch.float32)
    cands = [up]
    for _ in range(64):
        up, down = torch.nextafter(up, up + 1), torch.nextafter(down, down - 1)
        cands += [up, down]
    ulps = torch.stack(cands)
    hit = _edge(ulps, thr, divisor, far)
    return float(ulps[hit][0]) if bool(hit.any()) else None


def bisection_path(gg: int) -> list:
    """The 8 gain indices the bisection tested on its way to gg."""
    return [(gg | ((1 << (8 - j)) - 1)) - (1 << (7 - j)) for j in range(8)]


def edge_rows(cfg, nbytes: int, seed: int):
    """(e f32 [11, ne/4], nbits_spec_adj int64 [11]): an all-zero frame; a
    full-scale frame, with its bit budget and with none (every threshold
    over: gain index 255); a row below every threshold (gain index 0); two
    rows, a quiet and a loud one, with energies exactly on the thresholds of
    EDGE_INDICES (rows 4-5), and two on their far edges (rows 6-7); three
    rows of random spectra."""
    tab = encoder_tables(cfg, nbytes * 8)
    d = tab.divisors["gain_estimate"]
    rng = np.random.default_rng(seed)
    ne, n4, nbits = cfg.ne, cfg.ne // 4, nbytes * 8
    full = torch.as_tensor(np.where(rng.random(ne) < 0.5, -1.0, 1.0) * 2.0 ** 22, dtype=torch.float32)
    spectra = torch.as_tensor(rng.standard_normal((3, ne)) * 10.0 ** rng.uniform(0, 4, (3, 1)),
                              dtype=torch.float32)
    e = _energies(torch.cat([torch.zeros(1, ne), full[None], full[None], spectra]))
    rows = [e[0], e[1], e[2], torch.full((n4,), LOW_DB)]
    for far in (False, True):
        edges = [v for g in EDGE_INDICES
                 if (v := _on_edge(float(g + tab.gg_off), d, far)) is not None]
        for lo, hi in ((-60.0, 40.0), (40.0, 140.0)):
            row = torch.as_tensor(rng.uniform(lo, hi, n4), dtype=torch.float32)
            at = rng.choice(n4, size=min(n4, len(edges)), replace=False)
            row[at] = torch.tensor(edges[: len(at)])
            rows.append(row)
    rows += list(e[3:])
    adj = [nbits, nbits, 0, nbits] + list(rng.integers(0, nbits + 1, len(rows) - 4))
    return torch.stack(rows).float(), torch.as_tensor(np.asarray(adj, np.int64))


# ------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("cfg,nbytes", CASES, ids=CASE_IDS)
def test_plain_version_equals_the_oracle(cfg, nbytes):
    """The plain version gives the oracle's scalar bisection, stream by
    stream, on the edge rows; the rows reach gain indices 0 and 255 and
    their edges land exactly on a threshold the bisection tests."""
    from lc3jax.ref.quant import SpectralQuantizer

    tab = encoder_tables(cfg, nbytes * 8)
    e, adj = edge_rows(cfg, nbytes, seed=cfg.fs + nbytes)
    got = E.gain_bisection_plain(e, adj, tab.gg_off, tab.divisors["gain_estimate"])
    oracle = SpectralQuantizer(cfg.ne, cfg.fs_ind)
    want = [oracle._gain_bisection(row.numpy(), tab.gg_off, int(a)) for row, a in zip(e, adj)]
    assert got.dtype == torch.int64 and got.tolist() == want
    assert got[2] == 255 and got[3] == 0
    d = tab.divisors["gain_estimate"]
    for first, far in ((4, False), (6, True)):
        hits = [bool(_edge(e[r], float(t + tab.gg_off), d, far).any())
                for r in (first, first + 1) for t in bisection_path(want[r])]
        assert any(hits), f"no {'far ' if far else ''}edge on a tested threshold"


@pytest.mark.parametrize("cfg,nbytes", CASES, ids=CASE_IDS)
def test_wrapper_takes_the_plain_version_on_the_cpu(cfg, nbytes):
    """On CPU tensors the wrapper returns the plain version's index and
    launches nothing; so does the encoder's spectral quantizer."""
    tab = encoder_tables(cfg, nbytes * 8)
    e, adj = edge_rows(cfg, nbytes, seed=cfg.fs - nbytes)
    before = _build.launches.copy()
    got = K.gain_estimate(e, adj, tab.gg_off, tab.divisors["gain_estimate"])
    want = E.gain_bisection_plain(e, adj, tab.gg_off, tab.divisors["gain_estimate"])
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert _build.launches == before


def _bad_args(case):
    tab = encoder_tables(ALL_CONFIGS[5], 960)
    e, adj, d = torch.zeros(3, 100), torch.zeros(3, dtype=torch.int64), tab.divisors["gain_estimate"]
    if case == "e float64":
        e = e.double()
    elif case == "e one row":
        e = e[0]
    elif case == "e no energies":
        e = e[:, :0]
    elif case == "adj int32":
        adj = adj.int()
    elif case == "adj streams":
        adj = adj[:2]
    elif case == "divisor float64":
        d = d.double()
    elif case == "divisor shape":
        d = d[None]
    elif case == "mixed devices":
        adj = adj.to("meta")
    elif case == "meta":
        e, adj, d = e.to("meta"), adj.to("meta"), d.to("meta")
    return e, adj, tab.gg_off, d


@pytest.mark.parametrize("case", ["e float64", "e one row", "e no energies", "adj int32",
                                  "adj streams", "divisor float64", "divisor shape",
                                  "mixed devices", "meta"])
def test_wrapper_refuses_bad_arguments(case):
    """Wrong dtypes, shapes and mixed devices raise on every device; a
    device that is neither the CPU nor a card raises too."""
    match = "unsupported device" if case == "meta" else "gain_estimate: .* must be"
    with pytest.raises(ValueError, match=match):
        K.gain_estimate(*_bad_args(case))


# -------------------------------------------------------------- on the card


# every configuration at both byte counts and S = 1, 37 (a partial block)
# and 2048; and S = 2047 at 48 kHz / 10 ms / 150 B, 40 B at 16 kHz / 10 ms
KERNEL_CASES = ([(c, NBYTES, (1, 37, 2048)) for c in ALL_CONFIGS]
                + [(ALL_CONFIGS[5], (150,), (2047,)), (ALL_CONFIGS[1], (40,), (2048,))])
KERNEL_IDS = CFG_IDS + ["48000-10ms-150B-S2047", "16000-10ms-40B-S2048"]


@pytest.mark.card
@pytest.mark.parametrize("cfg,nbytes_list,sizes", KERNEL_CASES, ids=KERNEL_IDS)
def test_kernel_equals_plain_on_the_card(cfg, nbytes_list, sizes):
    """The edge rows, then random spectra at levels from 0.1 to 1e5 with
    every seventh row an all-zero frame, every seventh a row below every
    threshold and every seventh a full-scale row with no bit budget: equal
    index for index; one launch a call."""
    dev = _card()
    for nbytes in nbytes_list:
        tab = encoder_tables(cfg, nbytes * 8, dev)
        d = tab.divisors["gain_estimate"]
        rows, adj_rows = edge_rows(cfg, nbytes, seed=cfg.fs * nbytes)
        rng = np.random.default_rng(nbytes)
        for S in sizes:
            x_f = rng.standard_normal((S, cfg.ne)) * 10.0 ** rng.uniform(-1, 5, (S, 1))
            kind = np.arange(S) % 7
            x_f[kind == 0] = 0.0
            x_f[kind == 2] = 2.0 ** 22
            e = _energies(torch.as_tensor(x_f, dtype=torch.float32))
            e[torch.as_tensor(kind == 1)] = LOW_DB
            adj = torch.as_tensor(np.where(kind == 2, 0, rng.integers(0, nbytes * 8 + 1, S)))
            k = min(S, rows.shape[0])
            e[:k], adj[:k] = rows[:k], adj_rows[:k]
            e, adj = e.to(dev), adj.to(dev)
            before = _build.launches["lc3t_gain_estimate"]
            got = K.gain_estimate(e, adj, tab.gg_off, d)
            assert _build.launches["lc3t_gain_estimate"] == before + 1
            want = E.gain_bisection_plain(e, adj, tab.gg_off, d)
            if not torch.equal(got, want):
                bad = (got != want).nonzero().flatten()[:8].tolist()
                raise AssertionError(f"{nbytes} B, S={S}: streams {bad} differ")


# every configuration at S = 37 and 40 B, and the benchmark cells' settings
STEP_CASES = ([(c, 37, 40) for c in ALL_CONFIGS]
              + [(ALL_CONFIGS[5], 2048, 120), (ALL_CONFIGS[1], 2048, 40),
                 (ALL_CONFIGS[11], 2048, 75)])
STEP_IDS = ([f"{i}-S37" for i in CFG_IDS]
            + ["48000-10ms-S2048", "16000-10ms-S2048", "48000-7.5ms-S2048"])
T_FRAMES = 6


def _pcm(cfg, S: int, seed: int) -> np.ndarray:
    """int16 [T_FRAMES, S, nf]: tones and noise at levels from silence to
    full scale, a level a stream."""
    rng = np.random.default_rng(seed)
    n = np.arange(T_FRAMES * cfg.nf)
    level = 10.0 ** rng.uniform(-5, 0, (S, 1)) * (rng.random((S, 1)) > 0.05)
    tone = np.sin(2 * np.pi * rng.uniform(50, cfg.fs / 2, (S, 1)) / cfg.fs * n)
    x = level * 32767 * np.where(rng.random((S, 1)) < 0.5, tone, rng.uniform(-1, 1, (S, n.size)))
    return np.clip(x, -32768, 32767).astype(np.int16).reshape(S, T_FRAMES, cfg.nf).transpose(1, 0, 2)


@pytest.mark.card
@pytest.mark.parametrize("cfg,S,nbytes", STEP_CASES, ids=STEP_IDS)
def test_replayed_encode_steps_equal_plain_on_the_card(cfg, S, nbytes, monkeypatch):
    """make_encode_step's replayed graph and the fused bytes step's (the
    serving encoder with the device pack), the kernel inside both, against
    the eager steps with the plain version put in its place, T_FRAMES
    frames: every field, the whole state and every byte equal, one kernel
    launch a replay."""
    from lc3jax_torch.coding.device import encode_bytes_step

    dev = _card()
    pcm = torch.as_tensor(_pcm(cfg, S, seed=S + cfg.fs), device=dev)
    step = E.make_encode_step(cfg, nbytes, device=dev)
    fused = BatchEncoder(cfg, S, nbytes, device=dev, device_pack=True)
    st = E.encoder_init(cfg, S, dev)
    got, got_bytes = [], []
    before = _build.launches["lc3t_gain_estimate"]
    for f in range(T_FRAMES):
        st, fields = step(st, pcm[f])
        got.append({k: v.clone() for k, v in fields.items() if torch.is_tensor(v)})
        got_bytes.append(fused.encode_tensor(pcm[f]).clone())
    assert _build.launches["lc3t_gain_estimate"] == before + 2 * T_FRAMES
    final = {k: v.clone() for k, v in _state_tensors(st)}
    monkeypatch.setattr(E, "gain_estimate", E.gain_bisection_plain)
    ref = ref_b = E.encoder_init(cfg, S, dev)
    for f in range(T_FRAMES):
        ref, fields = E.encode_step(cfg, nbytes, ref, pcm[f])
        want = {k: v for k, v in fields.items() if torch.is_tensor(v)}
        assert got[f].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[f][k], v), f"frame {f}: field {k}"
        ref_b, want_bytes = encode_bytes_step(cfg, nbytes, ref_b, pcm[f])
        assert torch.equal(got_bytes[f], want_bytes), f"frame {f}: bytes"
    ref_state = dict(_state_tensors(ref))
    assert final.keys() == ref_state.keys()
    for k, v in ref_state.items():
        assert torch.equal(final[k], v), f"state {k}"


def _state_tensors(st, prefix=""):
    import dataclasses

    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if dataclasses.is_dataclass(v):
            yield from _state_tensors(v, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", v
