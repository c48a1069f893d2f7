"""Frame side-info parsing (reference decoder/side_info_reader.rs:29-200).

Side info lives at the tail of the frame, written backwards: bandwidth,
lastnz, lsb_mode, global gain, TNS activation flags, pitch-present, the
SNS-VQ multiplexed indices, LTPF info and the noise factor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .bitstream import BufferReader

NBITS_BW_TABLE = [0, 1, 2, 2, 3]


class SideInfoError(Exception):
    """Raised on malformed side info; routes the frame to PLC."""


@dataclass
class SnsVq:
    ind_lf: int
    ind_hf: int
    ls_inda: int
    ls_indb: int
    idx_a: int
    idx_b: int
    submode_lsb: int
    submode_msb: int
    g_ind: int


@dataclass
class LtpfInfo:
    pitch_present: bool
    is_active: bool
    pitch_index: int


@dataclass
class SideInfo:
    bandwidth: int  # P_BW 0..4
    lastnz: int
    lsb_mode: bool
    global_gain_index: int
    num_tns_filters: int
    reflect_coef_order_ari_input: list
    sns_vq: SnsVq
    ltpf: LtpfInfo
    noise_factor: int


def read_side_info(buf: bytes, reader: BufferReader, fs_ind: int, ne: int) -> SideInfo:
    nbits_bw = NBITS_BW_TABLE[fs_ind]
    if nbits_bw > 0:
        p_bw = reader.read_tail_uint(buf, nbits_bw)
        if fs_ind < p_bw:
            raise SideInfoError(f"bandwidth index {p_bw} out of range for fs_ind {fs_ind}")
    else:
        p_bw = 0

    lastnz_num_bits = math.ceil(math.log2(ne // 2))
    lastnz = (reader.read_tail_uint(buf, lastnz_num_bits) + 1) << 1
    if lastnz > ne:
        raise SideInfoError(f"lastnz {lastnz} > ne {ne}")

    lsb_mode = reader.read_tail_bool(buf)
    gg_ind = reader.read_tail_uint(buf, 8)

    num_tns_filters = 1 if p_bw < 3 else 2
    rc_order = [0, 0]
    for f in range(num_tns_filters):
        rc_order[f] = int(reader.read_tail_bool(buf))

    pitch_present = reader.read_tail_bool(buf)
    sns_vq = _read_sns_vq(buf, reader)

    if pitch_present:
        ltpf_active = reader.read_tail_bool(buf)
        pitch_index = reader.read_tail_uint(buf, 9)
    else:
        ltpf_active = False
        pitch_index = 0

    f_nf = reader.read_tail_uint(buf, 3)

    return SideInfo(
        bandwidth=p_bw,
        lastnz=lastnz,
        lsb_mode=lsb_mode,
        global_gain_index=gg_ind,
        num_tns_filters=num_tns_filters,
        reflect_coef_order_ari_input=rc_order,
        sns_vq=sns_vq,
        ltpf=LtpfInfo(pitch_present, ltpf_active, pitch_index),
        noise_factor=f_nf,
    )


def _read_sns_vq(buf: bytes, reader: BufferReader) -> SnsVq:
    ind_lf = reader.read_tail_uint(buf, 5)
    ind_hf = reader.read_tail_uint(buf, 5)

    submode_msb = int(reader.read_tail_bool(buf))
    g_ind = reader.read_tail_uint(buf, 1 if submode_msb == 0 else 2)
    ls_inda = int(reader.read_tail_bool(buf))

    ls_indb = 0
    idx_b = 0
    submode_lsb = 0
    if submode_msb == 0:
        tmp = reader.read_tail_uint(buf, 25)
        if tmp >= 33460056:
            raise SideInfoError(f"SNS stage-2 index {tmp} out of range (PLC trigger)")
        idx_bor_gain_lsb = tmp // 2390004
        idx_a = tmp - idx_bor_gain_lsb * 2390004
        idx_bor_gain_lsb -= 2
        if idx_bor_gain_lsb < 0:
            submode_lsb = 1
        idx_bor_gain_lsb += submode_lsb * 2
        if submode_lsb != 0:
            g_ind = (g_ind << 1) + idx_bor_gain_lsb
        else:
            idx_b = idx_bor_gain_lsb >> 1
            ls_indb = idx_bor_gain_lsb & 1
    else:
        tmp = reader.read_tail_uint(buf, 24)
        if tmp >= 16708096:
            raise SideInfoError(f"SNS stage-2 index {tmp} out of range (PLC trigger)")
        if tmp >= 15158272:
            tmp -= 15158272
            submode_lsb = 1
            g_ind = (g_ind << 1) + (tmp & 1)
            idx_a = tmp >> 1
        else:
            idx_a = tmp

    return SnsVq(
        ind_lf=ind_lf,
        ind_hf=ind_hf,
        ls_inda=ls_inda,
        ls_indb=ls_indb,
        idx_a=idx_a,
        idx_b=idx_b,
        submode_lsb=submode_lsb,
        submode_msb=submode_msb,
        g_ind=g_ind,
    )
