"""LC3 frame assembly on tensors: the encoder's fields -> frame bytes (port
of lc3jax/coding/pallas_pack.py:device_pack).

`device_pack` routes a CUDA tensor to the pack kernel (csrc/pack.cu, a lane
per stream coding into a row in shared memory, a scalar transcription of the
repo's host packer native/lc3_bitstream.cc:pack_one) and a CPU tensor to
`device_pack_plain`.

The plain version is a second, independent formulation: it follows the TPU
kernel's lane-parallel scheme, every stream a lane of an [S] int64 tensor.

- The range coder (`RangeEncoderLanes`) walks one symbol schedule for all
  lanes, each symbol masked per lane: the TNS symbols, then per tuple the
  batch's deepest escape ladder and the final symbol. Instead of the
  reference's cache and carry_count, it writes every byte optimistically at
  its slot (low >> 16), marks each group of pending bytes that a carry
  closes, and applies the carries at the end: +1 (mod 256) at the group's
  cache byte, 0 over its pending bytes, or 0 over all of it where no cache
  byte existed (pallas_pack.py:21-30). Groups never overlap, so the fix-up
  is a cumulative count over the byte positions, not a loop.
- The backward tail is a bit array [S, 8 * nbytes]: the side info, the
  spectral tail bits and the residual or LSB bits are each written as one
  scatter of chunks at running offsets. They do not depend on the coder, only
  the budget of the last part does.
- Head and tail meet by OR in the frame's last head byte, as in the host
  packer.

Both follow the oracle (lc3jax/ref/bitstream_enc.py) where the TPU kernel's
slot formula departs from it: the bit forecast counts the cache byte even
where none exists yet while bytes are pending, and the finish writes that
missing cache byte as 0xFF.

The range coder's u32 arithmetic is carried in int64, where none of it
overflows. Reference semantics: encoder/bitstream_encoding.rs and
encoder/buffer_writer.rs.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _build
from .. import tables as T
from ..config import FrameDuration, Lc3Config

I64 = torch.int64

NBITS_BW = (0, 1, 2, 2, 3)  # bandwidth field width by fs_ind
SIDE_ROWS = 34  # rows of the side matrix csrc/pack.cu reads (enum Side)
# int32 table buffer, in the order and at the offsets csrc/pack.cu expects
_TABLE_ORDER = (
    (T.AC_TNS_ORDER_CUMFREQ, 0), (T.AC_TNS_ORDER_FREQ, 16),
    (T.AC_TNS_COEF_CUMFREQ, 32), (T.AC_TNS_COEF_FREQ, 168),
)
TABLE_WORDS = 304


def lpc_weighting(cfg: Lc3Config, nbytes: int) -> int:
    """The TNS order table row: 1 below 480 frame bits (360 at 7.5 ms)."""
    return 1 if nbytes * 8 < (360 if cfg.n_ms == FrameDuration.MS7P5 else 480) else 0


@lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    parts = []
    for tab, offset in _TABLE_ORDER:
        assert sum(p.size for p in parts) == offset
        parts.append(np.asarray(tab, np.int64).ravel())
    buf = np.concatenate(parts)
    assert buf.size == TABLE_WORDS
    return torch.as_tensor(buf.astype(np.int32), device=device)


# ------------------------------------------------------------ range coder


class RangeEncoderLanes:
    """The LC3 range encoder over S lanes at once, with optimistic byte slots.

    `encode(cum, freq, active)` codes one symbol in each active lane;
    `forecast()` is the reference's bit forecast; `finish()` ends every lane
    and returns its head bytes. `width` bounds the slots kept (writes past it
    are dropped)."""

    def __init__(self, S: int, width: int, device):
        z = lambda dt=I64: torch.zeros(S, dtype=dt, device=device)  # noqa: E731
        self.width = width
        self.low, self.bp, self.rstart = z(), z(), z()
        self.rng = torch.full((S,), 0x00FFFFFF, dtype=I64, device=device)
        self.carry, self.hasc, self.hl0 = z(torch.bool), z(torch.bool), z(torch.bool)
        # column `width` takes the writes past the frame
        self.slots = torch.zeros(S, width + 1, dtype=I64, device=device)
        self.starts = torch.zeros_like(self.slots)  # cache byte of a carried group
        self.ends = torch.zeros_like(self.slots)  # the flush that closed it
        self._pows = 1 << torch.arange(1, 25, dtype=I64, device=device)

    def _at(self, pos):
        return pos.clamp(max=self.width)[:, None]

    def _shift(self, do):
        """ac_shift minus its byte writes: the slot takes low >> 16; a flush
        with a carry marks the group it closes."""
        flush = do & ((self.low < 0x00FF0000) | self.carry)
        carried = flush & self.carry
        self.starts.scatter_add_(1, self._at(self.rstart), carried.long()[:, None])
        self.ends.scatter_add_(1, self._at(self.bp), carried.long()[:, None])
        self.hl0 = self.hl0 | (carried & ~self.hasc)  # pendings before any cache byte
        self.slots.scatter_add_(1, self._at(self.bp), torch.where(do, self.low >> 16, 0)[:, None])
        self.rstart = torch.where(flush, self.bp, self.rstart)
        self.hasc = self.hasc | flush
        self.carry = self.carry & ~flush
        self.bp = self.bp + do.long()
        self.low = torch.where(do, (self.low << 8) & 0x00FFFFFF, self.low)

    def encode(self, cum, freq, active):
        """One symbol (cum, freq) [S] in the lanes where `active` [S]."""
        r = self.rng >> 10
        low = self.low + torch.where(active, r * cum, 0)
        self.carry = self.carry | (low >= 1 << 24)
        self.low = low & 0x00FFFFFF
        self.rng = torch.where(active, r * freq, self.rng)
        for _ in range(2):  # a valid symbol needs at most two renormalisations
            need = active & (self.rng < 0x10000)
            if not bool(need.any()):
                break
            self.rng = torch.where(need, self.rng << 8, self.rng)
            self._shift(need)

    def _log2_range(self):
        return (self.rng[:, None] >= self._pows).sum(1)

    def forecast(self):
        """Bits the head will hold once finished (the reference's
        nbits_ari): its cache byte is counted even before one exists."""
        return 8 * self.bp + 25 - self._log2_range() + torch.where(self.hasc, 0, 8)

    def finish(self):
        """ac_finish -> (head bytes int64 [S, width], need_extra bool [S])."""
        bits = (24 - self._log2_range()).clamp(min=1)
        mask = torch.full_like(bits, 0x00FFFFFF) >> bits
        low = self.low
        val = low + mask
        high = low + self.rng
        same = (val >> 24) == (high >> 24)
        val = val & (0x00FFFFFF & ~mask)
        need_extra = same & (val + mask >= high)
        bits = bits + need_extra.long()
        mask = torch.where(need_extra, mask >> 1, mask)
        val = torch.where(need_extra, ((low + mask) & 0x00FFFFFF) & ~mask, val)
        self.carry = self.carry | (same & (val < low))
        self.low = val
        left = bits
        for _ in range(4):  # bits <= 25
            do = left > 0
            self._shift(do)
            left = left - torch.where(do, 8, 0)
        # every slot pended and no cache byte ever existed: the reference
        # writes that cache byte (0xFF) ahead of them, one byte more
        headless = ~self.hasc
        self.slots.scatter_add_(1, self._at(self.bp), torch.where(headless, 0xFF, 0)[:, None])
        self.bp = self.bp + headless.long()
        # the last byte is partial: only its top bits belong to the head
        bits_fin = (bits - 1) % 8 + 1
        last = self._at(self.bp - 1)
        keep = (~(0xFF >> bits_fin)) & 0xFF
        self.slots.scatter_(1, last, self.slots.gather(1, last) & keep[:, None])
        # carried groups: +1 at the cache byte, 0 over the pending bytes; a
        # headless group at 0 has no cache byte, so all of it becomes 0
        W = self.width
        starts, ends = self.starts[:, :W] > 0, self.ends[:, :W] > 0
        pending = (starts.long().cumsum(1) - starts.long()) - ends.long().cumsum(1) > 0
        head = self.slots[:, :W]
        head = torch.where(starts, (head + 1) & 0xFF, head)
        pending[:, 0] = starts[:, 0] & self.hl0
        return torch.where(pending, 0, head), need_extra

    def carried(self):
        """Lanes in which a carry rewrote bytes already emitted."""
        return (self.starts[:, : self.width] > 0).any(1)


def range_encode_plain(cum, freq, active, width: int) -> RangeEncoderLanes:
    """Codes per-lane symbol sequences, cum, freq, active [S, N], column by
    column; returns the coder, to be finished or forecast."""
    coder = RangeEncoderLanes(cum.shape[0], width, cum.device)
    cum_t, freq_t, active_t = (t.t().contiguous() for t in (cum, freq, active))
    for j in range(cum_t.shape[0]):
        coder.encode(cum_t[j], freq_t[j], active_t[j])
    return coder


# ---------------------------------------------------------------- tail bits


def _put_bits(tail, cursor, vals, nbits, width: int):
    """Backward-writes chunk after chunk of each lane, each LSB first, from
    the lane's cursor: vals, nbits int64 [S, K] (a chunk of 0 bits is
    skipped; at most `width` bits each). tail: int64 [S, TB + 1], its last
    column takes the bits past the frame. Returns the advanced cursor."""
    S = tail.shape[0]
    trash = tail.shape[1] - 1
    j = torch.arange(width, device=tail.device)
    start = cursor[:, None] + nbits.cumsum(1) - nbits
    on = j < nbits[:, :, None]
    pos = torch.where(on, start[:, :, None] + j, trash).clamp(max=trash)
    bit = torch.where(on, (vals[:, :, None] >> j) & 1, 0)
    tail.scatter_add_(1, pos.reshape(S, -1), bit.reshape(S, -1))
    return cursor + nbits.sum(1)


def _side_chunks(cfg: Lc3Config, f: dict):
    """(vals, nbits) [S, 17] of the side info, in writing order
    (bitstream_encoding.rs:77-136)."""
    L = lambda k: f[k].long()  # noqa: E731
    S = f["x_q"].shape[0]
    dev = f["x_q"].device
    full = lambda n: torch.full((S,), n, dtype=I64, device=dev)  # noqa: E731
    num_tns = L("tns_num_tns_filters")
    order = f["tns_rc_order"].long()
    shape_j = L("sns_shape_j") & 3
    msb = (shape_j >> 1) != 0
    joint = L("sns_index_joint_j")
    low_bits = torch.where(msb, 12, 13)
    pitch = f["ltpf_pitch_present"].bool()
    chunks = [
        (L("bandwidth"), full(NBITS_BW[cfg.fs_ind])),
        ((L("quant_lastnz_trunc").clamp(0, cfg.ne) >> 1) - 1,
         full(int(np.ceil(np.log2(cfg.ne / 2.0))))),
        (L("quant_lsb_mode"), full(1)),
        (L("quant_gg_ind"), full(8)),
        ((order[:, 0] != 0).long(), (num_tns > 0).long()),
        ((order[:, 1] != 0).long(), (num_tns > 1).long()),
        (pitch.long(), full(1)),
        (L("sns_ind_lf"), full(5)),
        (L("sns_ind_hf"), full(5)),
        (msb.long(), full(1)),
        (L("sns_gind") >> (shape_j & 1), torch.where(shape_j < 2, 1, 2)),
        ((L("sns_ls_inda") != 0).long(), full(1)),
        (joint, low_bits),
        (joint >> low_bits, full(12)),
        (L("ltpf_ltpf_active"), pitch.long()),
        (L("ltpf_pitch_index"), 9 * pitch.long()),
        (L("noise_factor"), full(3)),
    ]
    return (torch.stack([v for v, _ in chunks], 1), torch.stack([n for _, n in chunks], 1))


# ------------------------------------------------------------- plain pack


def device_pack_plain(cfg: Lc3Config, nbytes: int, fields: dict, stats: bool = False):
    """Encoder fields (encode_step(..., emit_pack=True), tensors on one
    device) -> uint8 [S, nbytes], as plain tensor ops. With stats, also
    {"lsb_mode", "carry", "need_extra"}: bool [S] per frame, whether it
    coded in LSB mode, whether a carry rewrote emitted bytes, and whether
    the finish took its extra bit."""
    f = fields
    x = f["x_q"].long()
    S, ne = x.shape
    NT = ne // 2
    dev = x.device
    pk = f["quant_pack_tables"]
    if tuple(pk.shape) != (5 * NT, S):
        raise ValueError(f"device_pack_plain: quant_pack_tables must be [{5 * NT}, {S}], "
                         f"got {tuple(pk.shape)}")
    lsb = f["quant_lsb_mode"].bool()
    lastnz = f["quant_lastnz_trunc"].long().clamp(0, ne) & ~1
    coded = torch.arange(NT, device=dev)[None, :] < (lastnz >> 1)[:, None]  # [S, NT]

    # per tuple: magnitudes, escape-ladder depth
    xa, xb = x[:, 0::2], x[:, 1::2]
    a0, b0 = xa.abs(), xb.abs()
    g = (torch.maximum(a0, b0)[:, :, None] >= (4 << torch.arange(14, device=dev))).sum(2)

    # ---- tail: side info, then each coded tuple's ladder bits and signs
    tail = torch.zeros(S, 8 * nbytes + 1, dtype=I64, device=dev)
    cursor = _put_bits(tail, torch.zeros(S, dtype=I64, device=dev), *_side_chunks(cfg, f), 13)
    vacc = torch.zeros_like(a0)
    nacc = torch.zeros_like(a0)
    for it in range(14):
        to_tail = coded & (it < g) & ~(lsb[:, None] & (it == 0))
        pair = ((a0 >> it) & 1) | (((b0 >> it) & 1) << 1)
        vacc = vacc | torch.where(to_tail, pair << nacc, 0)
        nacc = nacc + 2 * to_tail.long()
    halve = lsb[:, None] & (g > 0)
    for mag, xv in ((a0, xa), (b0, xb)):
        on = coded & (torch.where(halve, mag >> 1, mag) > 0)
        vacc = vacc | torch.where(on, (xv <= 0).long() << nacc, 0)
        nacc = nacc + on.long()
    cursor = _put_bits(tail, cursor, vacc, nacc, 30)

    # ---- the symbol schedule: TNS, then per tuple its escapes and final
    lpcw = lpc_weighting(cfg, nbytes)
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
    ocum, ofrq = t64(T.AC_TNS_ORDER_CUMFREQ)[lpcw], t64(T.AC_TNS_ORDER_FREQ)[lpcw]
    ccum, cfrq = t64(T.AC_TNS_COEF_CUMFREQ), t64(T.AC_TNS_COEF_FREQ)
    num_tns = f["tns_num_tns_filters"].long()
    rc_i = f["tns_rc_i"].long().clamp(0, 16)
    cums, freqs, acts = [], [], []
    for fi in range(2):
        order = f["tns_rc_order"][:, fi].long().clamp(0, 8)
        on = (fi < num_tns) & (order > 0)
        o = (order - 1).clamp(min=0)
        cums.append(ocum[o]), freqs.append(ofrq[o]), acts.append(on)
        for k in range(8):
            r = rc_i[:, 8 * fi + k]
            cums.append(ccum[k][r]), freqs.append(cfrq[k][r]), acts.append(on & (k < order))
    depth = torch.where(coded, g, 0).amax(0).tolist() if S else []
    n_tup = int((lastnz >> 1).max()) if S else 0
    tup = np.concatenate([np.full(d + 1, p) for p, d in enumerate(depth[:n_tup])] + [[]])
    lev = np.concatenate([np.r_[np.arange(d), -1] for d in depth[:n_tup]] + [[]])  # -1: final
    tup_t, lev_t = t64(tup), t64(lev)
    ops = pk[torch.where(lev_t < 0, 4 * NT, lev_t.clamp(max=3) * NT) + tup_t].long().t()
    spec_on = coded[:, tup_t] & ((lev_t < 0) | (lev_t < g[:, tup_t]))
    coder = range_encode_plain(torch.cat([torch.stack(cums, 1), ops & 1023], 1),
                               torch.cat([torch.stack(freqs, 1), ops >> 10], 1),
                               torch.cat([torch.stack(acts, 1), spec_on], 1), nbytes)

    # ---- the gap: residual bits in nonzero-line order, or the LSB queue
    budget = (nbytes * 8 - cursor - coder.forecast()).clamp(min=0)
    nz = x != 0
    rank = nz.long().cumsum(1) - 1
    limit = torch.minimum(budget, f["n_residual"].long())
    can = nz & (rank < limit[:, None]) & ~lsb[:, None]
    cursor = _put_bits(tail, cursor, f["residual_bits"].long(), can.long(), 1)
    esc = lsb[:, None] & coded & (g > 0)
    queue = torch.stack([esc, esc & ((a0 >> 1) == 0) & (xa != 0),
                         esc, esc & ((b0 >> 1) == 0) & (xb != 0)], 2).reshape(S, -1)
    qvals = torch.stack([a0 & 1, (xa <= 0).long(), b0 & 1, (xb <= 0).long()], 2).reshape(S, -1)
    take = queue & (queue.long().cumsum(1) - 1 < budget[:, None])
    _put_bits(tail, cursor, qvals, take.long(), 1)

    head, need_extra = coder.finish()
    bits = tail[:, : 8 * nbytes].reshape(S, nbytes, 8) << torch.arange(8, device=dev)
    out = (head | bits.sum(2).flip(1)).to(torch.uint8)
    if stats:
        return out, {"lsb_mode": lsb, "carry": coder.carried(), "need_extra": need_extra}
    return out


# ------------------------------------------------------------- the kernel


def side_rows(fields: dict) -> torch.Tensor:
    """The int32 [34, S] side matrix of csrc/pack.cu (enum Side)."""
    i32 = lambda k: fields[k].to(torch.int32)  # noqa: E731
    order = fields["tns_rc_order"].to(torch.int32)
    rows = [i32("quant_lastnz_trunc"), i32("quant_lsb_mode"), i32("quant_gg_ind"),
            i32("tns_num_tns_filters"), order[:, 0], order[:, 1], i32("ltpf_pitch_present"),
            i32("ltpf_ltpf_active"), i32("ltpf_pitch_index"), i32("sns_ind_lf"),
            i32("sns_ind_hf"), i32("sns_shape_j"), i32("sns_gind"), i32("sns_ls_inda"),
            i32("sns_index_joint_j"), i32("bandwidth"), i32("noise_factor"),
            i32("n_residual")]
    return torch.cat([torch.stack(rows), fields["tns_rc_i"].to(torch.int32).t()]).contiguous()


def device_pack(cfg: Lc3Config, nbytes: int, fields: dict) -> torch.Tensor:
    """Encoder fields (encode_step(..., emit_pack=True), tensors on one
    device) -> uint8 [S, nbytes] on that device, for any S >= 1.

    A CPU tensor takes device_pack_plain; a CUDA tensor launches the pack
    kernel or raises."""
    x_q = fields["x_q"]
    if "quant_pack_tables" not in fields:
        raise ValueError("device_pack needs quant_pack_tables: run encode_step with "
                         "emit_pack=True")
    if x_q.device.type == "cpu":
        return device_pack_plain(cfg, nbytes, fields)
    if x_q.device.type != "cuda":
        raise ValueError(f"device_pack: unsupported device {x_q.device}")
    S, ne = x_q.shape
    res, pk = fields["residual_bits"], fields["quant_pack_tables"]
    for name, t, shape, dtype in (("x_q", x_q, (S, cfg.ne), torch.int32),
                                  ("residual_bits", res, (S, cfg.ne), torch.bool),
                                  ("quant_pack_tables", pk, (5 * (cfg.ne // 2), S), torch.int32)):
        if t.device != x_q.device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"device_pack: {name} must be {dtype} {shape} on {x_q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    # the contiguous views stay bound to names until the launch is queued
    xq_c, res_c, pk_c = x_q.contiguous(), res.contiguous(), pk.contiguous()
    side = side_rows(fields)
    tab = _tables(x_q.device)
    out = res_c.new_empty((S, nbytes), dtype=torch.uint8)
    _build.launch("lc3t_pack", x_q.get_device(), xq_c.data_ptr(), res_c.data_ptr(),
                  side.data_ptr(), pk_c.data_ptr(), tab.data_ptr(), out.data_ptr(), S, ne,
                  nbytes, NBITS_BW[cfg.fs_ind], lpc_weighting(cfg, nbytes))
    return out
