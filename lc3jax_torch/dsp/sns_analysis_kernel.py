"""Encoder SNS analysis around the PVQ search: the two CUDA kernels
(csrc/sns_analysis.cu) and their wrappers; the plain PyTorch versions are
encoder.sns_front_plain and encoder.sns_finish_plain.

Replaces no `pallas_call`: lc3jax/dsp/encoder.py:sns_analysis computes the
stage as XLA glue, which XLA fused into the jitted step on the TPU. Eager
PyTorch ran it as about 1,050 graph nodes a step around the PVQ kernel
(sns_kernel.py); the stage is now three launches: sns_front (the scale
factors, the stage-1 codebook search, the DCT-16 rotation), the PVQ
search, and sns_finish (the MPVQ enumerations and the joint index, the
DCT-16 synthesis, the interpolation, exp2f and the shaping). The kernels
fold every sum in the plain versions' order (the note in the source says
how). One algorithm serves all twelve configurations: nb and the attack
attenuation come from the configuration, ne from the spectrum's shape.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The wrappers check every argument on every device, so a CPU caller
meets the same contract.
"""

from __future__ import annotations

import torch

from .. import _build
from . import libmexact


def _check(site: str, dev, args) -> None:
    """Each (name, tensor, shape, dtype) on `dev`, of that shape and dtype."""
    for name, t, shape, dtype in args:
        if t.device != dev or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{site}: {name} must be {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_tables(site: str, dev, tables: dict) -> None:
    for name, t in tables.items():
        if t.device != dev:
            raise ValueError(f"{site}: the table {name} must be on {dev}, got {t.device}")


def _streams(site: str, t, name: str, width: int) -> int:
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] < 1 or t.shape[1] != width:
        raise ValueError(f"{site}: {name} must be float32 [S, {width}], "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.shape[0]


def _launch_device(site: str, t) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for any other."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{site}: unsupported device {t.device}")
    return t.device.type == "cuda"


def sns_front(tab, e_b, attack):
    """The scale factors, the stage-1 codebook search and the rotation, from
    the band energies e_b (f32 [S, nb]) and the attack flags (bool [S]), on
    the encoder tables `tab` of e_b's device: (t2rot f32 [S, 16], st1 f32
    [S, 16], ind_lf int64 [S], ind_hf int64 [S]). On the card one launch
    writes them into fresh tensors and reads nothing on the host."""
    cfg = tab.p.cfg
    S = _streams("sns_front", e_b, "e_b", cfg.nb)
    dev = e_b.device
    _check("sns_front", dev, [("attack", attack, (S,), torch.bool)])
    d5, d3 = tab.divisors["sns_attack_5"], tab.divisors["sns_attack_3"]
    _check_tables("sns_front", dev, dict(
        preemph=tab.preemph, group_idx=tab.group_idx, group_w=tab.group_w, lfcb=tab.lfcb,
        hfcb=tab.hfcb, dct16=tab.dct16, sns_attack_5=d5, sns_attack_3=d3))
    if not _launch_device("sns_front", e_b):
        from .encoder import sns_front_plain

        return sns_front_plain(tab, e_b, attack)
    e_b, attack = (t if t.is_contiguous() else t.contiguous() for t in (e_b, attack))
    t2rot = e_b.new_empty((S, 16))
    st1 = e_b.new_empty((S, 16))
    ind_lf = e_b.new_empty((S,), dtype=torch.int64)
    ind_hf = e_b.new_empty((S,), dtype=torch.int64)
    _build.launch("lc3t_sns_front", e_b.get_device(), e_b.data_ptr(), attack.data_ptr(),
                  tab.preemph.data_ptr(), tab.group_idx.data_ptr(), tab.group_w.data_ptr(),
                  d5.data_ptr(), d3.data_ptr(), tab.lfcb.data_ptr(), tab.hfcb.data_ptr(),
                  tab.dct16.data_ptr(),
                  t2rot.data_ptr(), st1.data_ptr(), ind_lf.data_ptr(), ind_hf.data_ptr(),
                  S, cfg.nb, tab.p.sns_attack_atten)
    return t2rot, st1, ind_lf, ind_hf


FIELDS = ("ind_lf", "ind_hf", "shape_j", "gind", "ls_inda", "ls_indb", "index_joint_j")


def sns_finish(tab, x, st1, ind_lf, ind_hf, y_sel, y0s, xq_sel, shape_j, gind, g_sel):
    """The shaped spectrum (f32 [S, ne]) and the seven SNS fields (int32
    [S] each, FIELDS), from the spectrum x (f32 [S, ne], rows may be
    strided), sns_front's st1, ind_lf and ind_hf, and the PVQ search's
    outputs (sns_kernel.sns_pvq), on the encoder tables `tab` of x's device.
    On the card one launch writes them into fresh tensors and reads nothing
    on the host."""
    cfg = tab.p.cfg
    S = _streams("sns_finish", x, "x", cfg.ne)
    dev = x.device
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    _check("sns_finish", dev, [
        ("st1", st1, (S, 16), f32), ("ind_lf", ind_lf, (S,), i64), ("ind_hf", ind_hf, (S,), i64),
        ("y_sel", y_sel, (S, 16), i32), ("y0s", y0s, (S, 16), i32),
        ("xq_sel", xq_sel, (S, 16), f32), ("shape_j", shape_j, (S,), i32),
        ("gind", gind, (S,), i32), ("g_sel", g_sel, (S,), f32)])
    _check_tables("sns_finish", dev, dict(dct16=tab.dct16, mpvq_offsets=tab.mpvq_offsets,
                                          band_of_line=tab.band_of_line))
    if not _launch_device("sns_finish", x):
        from .encoder import sns_finish_plain

        return sns_finish_plain(tab, x, st1, ind_lf, ind_hf, y_sel, y0s, xq_sel, shape_j, gind,
                                g_sel)
    if x.stride(1) != 1:
        x = x.contiguous()
    st1, ind_lf, ind_hf, y_sel, y0s, xq_sel, shape_j, gind, g_sel = (
        t if t.is_contiguous() else t.contiguous()
        for t in (st1, ind_lf, ind_hf, y_sel, y0s, xq_sel, shape_j, gind, g_sel))
    _, shift, (p0, p1, p2) = libmexact._host_table()
    x_shaped = x.new_empty((S, cfg.ne))
    fields = x.new_empty((len(FIELDS), S), dtype=i32)
    _build.launch("lc3t_sns_finish", x.get_device(), x.data_ptr(), st1.data_ptr(),
                  ind_lf.data_ptr(), ind_hf.data_ptr(), y_sel.data_ptr(), y0s.data_ptr(),
                  xq_sel.data_ptr(), shape_j.data_ptr(), gind.data_ptr(), g_sel.data_ptr(),
                  tab.dct16.data_ptr(), tab.mpvq_offsets.data_ptr(), tab.band_of_line.data_ptr(),
                  libmexact._table(dev).data_ptr(), x_shaped.data_ptr(), fields.data_ptr(),
                  S, cfg.ne, x.stride(0), cfg.nb, shift, p0, p1, p2)
    return x_shaped, dict(zip(FIELDS, fields.unbind(0)))
