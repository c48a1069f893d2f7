"""LC3 bitstream parsing on tensors: raw frame bytes -> ParsedFrames (port
of lc3jax/coding/device.py).

`device_parse` routes a CUDA tensor to the parse kernel (csrc/parse.cu, one
thread per stream, the whole frame in the kernel) and a CPU tensor to
`device_parse_plain`, the torch translation of the XLA formulation: reads
are per-stream gathers, the range decoder's symbol search is a
compare-and-count over the cumfreq row, and the tuple loop is a Python loop
vectorised over streams that stops at the batch-max lastnz. Corrupt frames
set bad_frame (PLC) instead of raising; their fields follow device.py
exactly, so kernel and plain version agree on every field of every frame.
An empty frame (nbytes 0, a lost packet delivered as a zero-byte SDU) reads
as zero bytes and overruns at its first read: every stream is concealed.
`make_decode_bytes_step` compiles the fused step (`compiled.CompiledStep`).

All range-coder arithmetic is u32 in the reference; here it is carried in
int64, where none of it overflows.

Reference semantics: decoder/side_info_reader.rs, decoder/buffer_reader.rs,
decoder/arithmetic_codec.rs, decoder/spectral_noise_shaping.rs:155-199.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import numpy as np
import torch

from .. import tables as T
from ..compiled import CompiledStep
from ..config import FrameDuration, Lc3Config

from ..dsp.decoder import ParsedFrames

I64 = torch.int64


def _readable(buf, nbytes: int):
    """buf int64 [S, nbytes] as the readers gather from it: an empty frame
    reads as one zero byte, so that no gather indexes an empty axis (every
    read of it overruns, so the frame is bad, as in csrc/parse.cu)."""
    return buf if nbytes else buf.new_zeros(buf.shape[0], 1)


class _TailReader:
    """Vectorised backwards bit reader: value reads are 4-byte gathers."""

    def __init__(self, buf, nbytes: int | None = None):
        self.nbytes = buf.shape[1] if nbytes is None else nbytes
        self.buf = _readable(buf, self.nbytes)  # int64 [S, max(nbytes, 1)]
        S = buf.shape[0]
        self.cursor = torch.zeros(S, dtype=I64, device=buf.device)
        self.error = torch.zeros(S, dtype=torch.bool, device=buf.device)
        self._j = torch.arange(4, device=buf.device)

    def read(self, nbits: int, advance=None, active=None):
        """Read nbits (<= 25); advance the cursor by `advance` (default
        nbits, may be per stream), which is also the bit count of the
        overrun check; `active` masks that check."""
        byte_index = self.cursor >> 3
        idx = (self.nbytes - 1 - byte_index)[:, None] - self._j
        vals = torch.gather(self.buf, 1, idx.clamp(0, self.buf.shape[1] - 1))
        vals = torch.where(idx >= 0, vals, 0)
        w = vals[:, 0] | (vals[:, 1] << 8) | (vals[:, 2] << 16) | (vals[:, 3] << 24)
        bit = self.cursor & 7
        value = (w >> bit) & ((1 << nbits) - 1)
        adv = torch.full_like(self.cursor, nbits) if advance is None else advance.to(I64)
        # overrun check of buffer_reader.rs:72 (side info precedes any head read)
        nb = (adv >> 3) + torch.where((adv > 8 - bit) & (adv < 8), 2, 1)
        overrun = (self.nbytes - byte_index - nb < 0) & (adv > 0)
        if active is not None:
            overrun = overrun & active
        self.error = self.error | overrun
        self.cursor = self.cursor + adv
        return value

    def read_masked(self, nbits: int, do):
        v = self.read(nbits, advance=torch.where(do, nbits, 0), active=do)
        return torch.where(do, v, 0)


@lru_cache(maxsize=None)
def _mpvq_rows(device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(T.MPVQ_OFFSETS, np.int64), device=device)


def mpvq_deenum(S, dim, k_val, ls_ind, ind, enabled):
    """MPVQ de-enumeration (spectral_noise_shaping.rs:155-199) -> int64 [S, 16]."""
    dev = ind.device
    rows = _mpvq_rows(dev)
    y = torch.zeros(S, 16, dtype=I64, device=dev)
    lead = torch.where(ls_ind == 0, 1, -1).to(I64)
    k_max = torch.full((S,), k_val, dtype=I64, device=dev)
    ind = ind.to(I64)
    done = ~enabled
    for p in range(dim):
        row = rows[dim - 1 - p]  # [11], nondecreasing
        hit_zero = ~done & (ind == 0)
        y[:, p] = torch.where(hit_zero, k_max * lead, y[:, p])
        done = done | hit_zero
        cnt = (ind[:, None] >= row[None, 1:]).sum(1)
        k_acc = torch.minimum(k_max, cnt)
        ind_new = ind - row[k_acc]
        k_delta = k_max - k_acc
        put = ~done & (k_delta != 0)
        y[:, p] = torch.where(put, k_delta * lead, y[:, p])
        lead = torch.where(put, torch.where((ind_new & 1) != 0, -1, 1), lead)
        ind = torch.where(~done, torch.where(put, ind_new >> 1, ind_new), ind)
        k_max = torch.where(put, k_acc, k_max)
    return y


def read_side_info(r, cfg: Lc3Config, S: int):
    """Side-info demux through a `_TailReader` (side_info_reader.rs:29-103);
    returns (fields dict, bad)."""
    ne, fs_ind = cfg.ne, cfg.fs_ind
    dev = r.cursor.device
    bad = torch.zeros(S, dtype=torch.bool, device=dev)

    nbits_bw = [0, 1, 2, 2, 3][fs_ind]
    if nbits_bw > 0:
        p_bw = r.read(nbits_bw)
        bad = bad | (p_bw > fs_ind)
        p_bw = torch.clamp(p_bw, max=fs_ind)
    else:
        p_bw = torch.zeros(S, dtype=I64, device=dev)

    lastnz = (r.read(math.ceil(math.log2(ne // 2))) + 1) << 1
    bad = bad | (lastnz > ne)
    lastnz = torch.clamp(lastnz, max=ne)

    lsb_mode = r.read(1).bool()
    gg_ind = r.read(8)

    num_tns = torch.where(p_bw < 3, 1, 2)
    rc_flag0 = r.read(1)
    rc_flag1 = r.read_masked(1, num_tns == 2)

    pitch_present = r.read(1).bool()

    # SNS VQ demux (side_info_reader.rs:127-200)
    ind_lf = r.read(5)
    ind_hf = r.read(5)
    submode_msb = r.read(1)
    msb0 = submode_msb == 0
    g2 = r.read(2, advance=torch.where(msb0, 1, 2))
    g_ind = torch.where(msb0, g2 & 1, g2 & 3)
    ls_inda = r.read(1)
    tmp = r.read(25, advance=torch.where(msb0, 25, 24))
    tmp = torch.where(msb0, tmp, tmp & 0xFFFFFF)
    bad = bad | torch.where(msb0, tmp >= 33460056, tmp >= 16708096)
    # shape 0/1 split
    idx_bor = tmp // 2390004
    idx_a0 = tmp - idx_bor * 2390004
    sub_lsb0 = (idx_bor - 2 < 0).to(I64)
    ib = idx_bor - 2 + sub_lsb0 * 2
    g_ind0 = torch.where(sub_lsb0 != 0, (g_ind << 1) + ib, g_ind)
    idx_b0 = torch.where(sub_lsb0 != 0, 0, ib >> 1)
    ls_indb0 = torch.where(sub_lsb0 != 0, 0, ib & 1)
    # shape 2/3 split
    hi = tmp >= 15158272
    tmp2 = tmp - torch.where(hi, 15158272, 0)
    sub_lsb1 = hi.to(I64)
    g_ind1 = torch.where(hi, (g_ind << 1) + (tmp2 & 1), g_ind)
    idx_a1 = torch.where(hi, tmp2 >> 1, tmp2)

    submode_lsb = torch.where(msb0, sub_lsb0, sub_lsb1)
    shape_j = (submode_msb << 1) + submode_lsb

    ltpf_active = r.read_masked(1, pitch_present).bool()
    pitch_index = r.read_masked(9, pitch_present)
    noise_factor = r.read(3)
    bad = bad | r.error  # tail-reader overrun during side info
    return dict(
        p_bw=p_bw, lastnz=lastnz, lsb_mode=lsb_mode, gg_ind=gg_ind,
        num_tns=num_tns, rc_flag0=rc_flag0, rc_flag1=rc_flag1,
        pitch_present=pitch_present, ind_lf=ind_lf, ind_hf=ind_hf,
        g_ind=torch.where(msb0, g_ind0, g_ind1),
        idx_a=torch.where(msb0, idx_a0, idx_a1),
        idx_b=torch.where(msb0, idx_b0, 0), ls_inda=ls_inda,
        ls_indb=torch.where(msb0, ls_indb0, 0), shape_j=shape_j,
        ltpf_active=ltpf_active, pitch_index=pitch_index, noise_factor=noise_factor,
    ), bad


@lru_cache(maxsize=None)
def _ac_tables(device):
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return dict(
        spec_cum=t(T.AC_SPEC_CUMFREQ), spec_freq=t(T.AC_SPEC_FREQ),
        lookup=t(T.AC_SPEC_LOOKUP), order_cum=t(T.AC_TNS_ORDER_CUMFREQ),
        order_freq=t(T.AC_TNS_ORDER_FREQ), coef_cum=t(T.AC_TNS_COEF_CUMFREQ),
        coef_freq=t(T.AC_TNS_COEF_FREQ),
    )


class _RangeDecoder:
    """Per-stream range decoder state with masked symbol decodes."""

    def __init__(self, buf, nbytes: int):
        self.buf = _readable(buf, nbytes)
        S, self.nbytes = buf.shape[0], nbytes
        dev = buf.device
        self.head = torch.zeros(S, dtype=I64, device=dev)
        self.err = torch.zeros(S, dtype=torch.bool, device=dev)
        b0, b1, b2 = (self._pull(None) for _ in range(3))
        self.low = (b0 << 16) | (b1 << 8) | b2
        self.rng = torch.full((S,), 0x00FFFFFF, dtype=I64, device=dev)

    def _pull(self, on):
        """Byte at the head cursor (clamped); advances where `on`."""
        byte = torch.gather(self.buf, 1, self.head.clamp(0, self.buf.shape[1] - 1)[:, None])[:, 0]
        over = self.head >= self.nbytes
        if on is None:
            self.err = self.err | over
            self.head = self.head + 1
        else:
            self.err = self.err | (on & over)
            self.head = self.head + on.to(I64)
        return byte

    def decode(self, cum_rows, freq_rows, active):
        """cum_rows/freq_rows: [S, K]. Masked range decode of one symbol."""
        tmp = self.rng >> 10
        self.err = self.err | (active & (self.low >= (tmp << 10)))
        val = (self.low[:, None] >= tmp[:, None] * cum_rows[:, 1:]).sum(1)
        cum_v = torch.gather(cum_rows, 1, val[:, None])[:, 0]
        frq_v = torch.gather(freq_rows, 1, val[:, None])[:, 0]
        low = torch.where(active, self.low - tmp * cum_v, self.low)
        rng = torch.where(active, tmp * frq_v, self.rng)
        for _ in range(2):  # renormalisation needs at most two byte pulls
            need = active & (rng < 0x10000)
            if not bool(need.any()):
                break
            byte = self._pull(need)
            low = torch.where(need, ((low << 8) & 0xFFFFFF) + byte, low)
            rng = torch.where(need, rng << 8, rng)
        self.low, self.rng = low, rng
        return val


def _tail_bit(buf, nbytes, cursor, do, head, err):
    """One backwards bit at `cursor` where `do` (buffer_reader.rs:104); buf
    as `_readable` gives it."""
    byte_index = cursor >> 3
    idx = (nbytes - 1 - byte_index).clamp(0, buf.shape[1] - 1)
    byte = torch.gather(buf, 1, idx[:, None])[:, 0]
    v = (((byte >> (cursor & 7)) & 1) != 0) & do
    err = err | (do & (nbytes - head - byte_index + 2 < 0))
    return v, cursor + do.to(I64), err


def device_parse_plain(cfg: Lc3Config, nbytes: int, payloads) -> ParsedFrames:
    """payloads: uint8 [S, nbytes] -> ParsedFrames, as plain tensor ops."""
    if payloads.dim() != 2 or payloads.shape[1] != nbytes:
        raise ValueError(f"payloads must be [S, {nbytes}], got {tuple(payloads.shape)}")
    S = payloads.shape[0]
    dev = payloads.device
    ne, fs_ind = cfg.ne, cfg.fs_ind
    nbits = nbytes * 8
    buf = _readable(payloads.to(I64), nbytes)
    tb = _ac_tables(dev)

    r = _TailReader(buf, nbytes)
    side, bad = read_side_info(r, cfg, S)
    lastnz, lsb_mode = side["lastnz"], side["lsb_mode"]

    # ---------------- arithmetic decoder init (arithmetic_codec.rs:57-65)
    ac = _RangeDecoder(buf, nbytes)

    # ---------------- TNS data (arithmetic_codec.rs:307-344)
    is_7p5 = cfg.n_ms == FrameDuration.MS7P5
    lpcw = 1 if nbits < (360 if is_7p5 else 480) else 0
    rc_order = torch.stack([side["rc_flag0"], side["rc_flag1"]], dim=1)
    rc_i = torch.zeros(S, 16, dtype=I64, device=dev)
    order_cum = tb["order_cum"][lpcw].expand(S, 8)
    order_freq = tb["order_freq"][lpcw].expand(S, 8)
    for f in range(2):
        in_filter = (f < side["num_tns"]) & (rc_order[:, f] > 0)
        val = ac.decode(order_cum, order_freq, in_filter)
        rc_order[:, f] = torch.where(in_filter, val + 1, rc_order[:, f])
        for k in range(8):
            ink = in_filter & (k < rc_order[:, f])
            val = ac.decode(tb["coef_cum"][k].expand(S, 17), tb["coef_freq"][k].expand(S, 17), ink)
            rc_i[:, f * 8 + k] = torch.where(ink, val, rc_i[:, f * 8 + k])

    # ---------------- spectral tuples (arithmetic_codec.rs:211-305)
    rate_flag = 512 if nbits > (160 + fs_ind * 160) else 0
    cursor = r.cursor
    c = torch.zeros(S, dtype=I64, device=dev)
    x = torch.zeros(S, ne, dtype=I64, device=dev)
    save_lev = torch.zeros(S, ne // 2, dtype=I64, device=dev)
    lim = torch.where(bad, 0, lastnz)
    n_end = int(lim.max()) if S else 0  # tuples past every stream's lastnz are no-ops
    for n in range(0, n_end, 2):
        in_range = n < lim
        t = c + (rate_flag + (256 if n > ne // 2 else 0))
        xk = torch.zeros(S, dtype=I64, device=dev)
        xk1 = torch.zeros_like(xk)
        sym = torch.zeros_like(xk)
        lev = torch.zeros_like(xk)
        going = in_range
        for _ in range(14):  # escape ladder; stops once no stream escapes
            pki = tb["lookup"][(t + torch.clamp(lev, max=3) * 1024).clamp(0, 4095)]
            val = ac.decode(tb["spec_cum"][pki], tb["spec_freq"][pki], going)
            sym = torch.where(going, val, sym)
            going = going & (val >= 16)
            if not bool(going.any()):
                break
            read_lsbs = going & (~lsb_mode | (lev > 0))
            bit_a, cursor, ac.err = _tail_bit(buf, nbytes, cursor, read_lsbs, ac.head, ac.err)
            bit_b, cursor, ac.err = _tail_bit(buf, nbytes, cursor, read_lsbs, ac.head, ac.err)
            xk = xk + (bit_a.to(I64) << lev)
            xk1 = xk1 + (bit_b.to(I64) << lev)
            lev = lev + going.to(I64)
        save_lev[:, n // 2] = torch.where(lsb_mode, lev, 0)
        a = sym & 3
        b = sym >> 2
        xk = xk + torch.where(in_range, a << lev, 0)
        xk1 = xk1 + torch.where(in_range, b << lev, 0)
        sbit, cursor, ac.err = _tail_bit(buf, nbytes, cursor, in_range & (xk > 0), ac.head, ac.err)
        xk = torch.where(sbit, -xk, xk)
        sbit, cursor, ac.err = _tail_bit(buf, nbytes, cursor, in_range & (xk1 > 0), ac.head, ac.err)
        xk1 = torch.where(sbit, -xk1, xk1)
        lev_c = torch.clamp(lev, max=3)
        t_next = torch.where(lev_c <= 1, 1 + (a + b) * (lev_c + 1), 12 + lev_c)
        c = torch.where(in_range, (c & 15) * 16 + t_next, c)
        x[:, n] = xk
        x[:, n + 1] = xk1

    # ---------------- residual bits (arithmetic_codec.rs:160-208, 390-405)
    pows = torch.tensor([1 << k for k in range(1, 25)], dtype=I64, device=dev)
    log2rng = (ac.rng[:, None] >= pows).sum(1)
    nbits_side = cursor - 8
    nbits_ari = (ac.head + 1 - 3) * 8 + 25 - log2rng
    neg_budget = nbits < nbits_side + nbits_ari
    nres_avail = torch.clamp(nbits - nbits_side - nbits_ari, min=0)

    head, err = ac.head, ac.err
    nz = x != 0
    bitpos = torch.cumsum(nz, dim=1) - 1
    can_read = nz & (bitpos < nres_avail[:, None]) & ~lsb_mode[:, None]
    read_cursor = cursor[:, None] + bitpos
    byte_index = read_cursor >> 3
    bytes_g = torch.gather(buf, 1, (nbytes - 1 - byte_index).clamp(0, buf.shape[1] - 1))
    residual_bits = (((bytes_g >> (read_cursor & 7)) & 1) != 0) & can_read
    n_residual = torch.where(lsb_mode, 0, can_read.sum(1))
    err = err | (can_read & (nbytes - head[:, None] - byte_index + 2 < 0)).any(1)
    bad = bad | err | neg_budget

    # ---------------- LSB refinement: sequential, budgeted; the reference
    # stops once the budget is spent, and masking by budget > 0 is the same
    lsb_on = lsb_mode & ~bad
    n_lsb = int(torch.where(lsb_on, lastnz, 0).max()) if S else 0
    cur, budget = cursor, nres_avail
    lerr = torch.zeros(S, dtype=torch.bool, device=dev)
    for n in range(0, n_lsb, 2):
        pair_on = lsb_on & (n < lastnz) & (save_lev[:, n // 2] > 0)
        for i in (n, n + 1):
            can = pair_on & (budget > 0)
            b1, cur, lerr = _tail_bit(buf, nbytes, cur, can, head, lerr)
            budget = budget - can.to(I64)
            xv = x[:, i]
            hit = can & b1
            can2 = hit & (xv == 0) & (budget > 0)
            b2, cur, lerr = _tail_bit(buf, nbytes, cur, can2, head, lerr)
            budget = budget - can2.to(I64)
            new = torch.where(hit & (xv > 0), xv + 1, xv)
            new = torch.where(hit & (xv < 0), new - 1, new)
            x[:, i] = torch.where(can2, torch.where(b2, -1, 1), new)
    bad = bad | lerr

    pos = torch.arange(ne, device=dev)
    seed = (torch.sum(x.abs() * pos, dim=1) & 0xFFFF)
    zero_frame = (lastnz == 2) & (x[:, 0] == 0) & (x[:, 1] == 0) & (side["gg_ind"] == 0)

    # ---------------- MPVQ de-enumeration (spectral_noise_shaping.rs:155-199)
    shape_j = side["shape_j"]
    zeros = torch.zeros(S, 16, dtype=I64, device=dev)

    def deenum(dim, k, ls, idx, on):
        return mpvq_deenum(S, dim, k, side[ls], side[idx], on) if bool(on.any()) else zeros

    yA10 = deenum(10, 10, "ls_inda", "idx_a", shape_j <= 1)
    yB6 = deenum(6, 1, "ls_indb", "idx_b", shape_j == 0)
    y2 = deenum(16, 8, "ls_inda", "idx_a", shape_j == 2)
    y3 = deenum(16, 6, "ls_inda", "idx_a", shape_j == 3)
    lane = torch.arange(16, device=dev)[None, :]
    y01 = torch.where(lane < 10, yA10,
                      torch.where(shape_j[:, None] == 0, torch.roll(yB6, 10, dims=1), 0))
    sns_y = torch.where(shape_j[:, None] <= 1, y01,
                        torch.where(shape_j[:, None] == 2, y2, y3))

    i32 = lambda t: t.to(torch.int32)
    return ParsedFrames(
        x_int=i32(torch.where(bad[:, None], 0, x)),
        lsb_mode=lsb_mode,
        gg_ind=i32(side["gg_ind"]),
        rc_order=i32(rc_order),
        rc_i=i32(rc_i),
        bandwidth=i32(side["p_bw"]),
        noise_factor=i32(side["noise_factor"]),
        nf_seed=i32(torch.where(bad, 0, seed)),
        zero_frame=zero_frame,
        residual_bits=residual_bits,
        n_residual=i32(n_residual),
        sns_y=i32(sns_y),
        sns_shape=i32(shape_j),
        sns_gind=i32(side["g_ind"]),
        sns_ind_lf=i32(side["ind_lf"]),
        sns_ind_hf=i32(side["ind_hf"]),
        ltpf_active=side["ltpf_active"] & ~bad,
        pitch_index=i32(torch.where(bad, 0, side["pitch_index"])),
        bad_frame=bad,
    )


def device_parse(cfg: Lc3Config, nbytes: int, payloads) -> ParsedFrames:
    """payloads: uint8 [S, nbytes] -> ParsedFrames on the same device.

    A CUDA tensor goes through the parse kernel; a CPU tensor through
    device_parse_plain."""
    if payloads.device.type == "cpu":
        return device_parse_plain(cfg, nbytes, payloads)
    from .parse_kernel import parse_frames_cuda

    return parse_frames_cuda(cfg, nbytes, payloads)


def decode_bytes_step(cfg: Lc3Config, nbytes: int, state, payloads):
    """Fused: raw frame bytes [S, nbytes] -> (state, PCM int16 [S, nf])."""
    from ..dsp.decoder import decode_step

    frames = device_parse(cfg, nbytes, payloads)
    return decode_step(cfg, nbytes * 8, state, frames)


def make_decode_bytes_step(cfg: Lc3Config, nbytes: int, device="cuda") -> CompiledStep:
    """decode_bytes_step compiled for (cfg, nbytes): `step(state, payloads)
    -> (state, pcm)`, one CUDA graph per stream count S on `device`: the
    fused counterpart of `dsp.decoder.make_decode_step` (lc3jax's
    `jax.jit(partial(decode_bytes_step, cfg, nbytes), donate_argnums=(0,))`).

    The state is donated: the state returned is the step's own buffers,
    passing it back costs no copy and updates it in place; a state of your
    own is copied in once, and passing it again raises. Another stream's
    state gets static buffers of its own, so two streams through one step
    stay independent. The PCM is a fresh tensor each call
    (`compiled.CompiledStep`)."""
    return CompiledStep(partial(decode_bytes_step, cfg, nbytes),
                        ("decode_bytes_step", cfg, nbytes), device)


def decode_bytes_step_stats(cfg: Lc3Config, nbytes: int, state, payloads):
    """decode_bytes_step that also returns the batch's concealed-frame count
    (a 0-dim device tensor), so fused-path serving can report plc_rate."""
    from ..dsp.decoder import decode_step

    frames = device_parse(cfg, nbytes, payloads)
    state, pcm = decode_step(cfg, nbytes * 8, state, frames)
    return state, pcm, frames.bad_frame.sum()


def encode_bytes_step(cfg: Lc3Config, nbytes: int, state, pcm):
    """Fused: int16 PCM [S, nf] -> (state, frame bytes uint8 [S, nbytes]) on
    the state's device: encode_step with emit_pack, then device_pack."""
    from ..dsp.encoder import encode_step
    from .pack_kernel import device_pack

    state, fields = encode_step(cfg, nbytes, state, pcm, emit_pack=True)
    return state, device_pack(cfg, nbytes, fields)
