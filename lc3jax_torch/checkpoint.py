"""Codec-state checkpoint and resume (port of lc3jax/checkpoint.py).

The whole per-stream resume state is the decoder's DecoderState (OLA
memory, PLC spectrum, seed and alpha, LTPF histories and coefficients) or
the encoder's EncoderState (MDCT history, attack scalars, LTPF histories,
gain-offset adaptation): nested dataclasses of tensors. A checkpoint is one
`.npz` in lc3jax's format, so a file either package writes loads in the
other:

- each leaf under its JAX key-path string (`.mem_ola`, `.ltpf.hist_x`, ...);
- `__lc3jax_meta__`: JSON bytes with `format_version` 2 and `config_tag`;
- written with `np.savez_compressed`.

Loading fails loudly (ValueError) on added, removed or renamed fields, a
shape or dtype change, or a config tag other than the saved one, rather
than restoring the wrong leaf.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

_FORMAT_VERSION = 2
_META_KEY = "__lc3jax_meta__"


def _leaves(state, prefix: str = ""):
    """(key path, tensor) of each leaf, depth first in field order."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        key = f"{prefix}.{f.name}"
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, key)
        else:
            yield key, v


def _rebuild(like, leaves: dict, prefix: str = ""):
    """A copy of `like` with each leaf replaced by leaves[key path]."""
    kw = {}
    for f in dataclasses.fields(like):
        v, key = getattr(like, f.name), f"{prefix}.{f.name}"
        kw[f.name] = _rebuild(v, leaves, key) if dataclasses.is_dataclass(v) else leaves[key]
    return dataclasses.replace(like, **kw)


def save_state(path: str, state, config_tag: str = "") -> None:
    """Write a DecoderState or EncoderState (on any device) to `path` (.npz).

    config_tag: a free-form stamp (e.g. "48000/MS10/S=2048/nbytes=150")
    checked on load when the loader passes a tag."""
    arrays = {k: v.cpu().numpy() for k, v in _leaves(state)}
    meta = {"format_version": _FORMAT_VERSION, "config_tag": config_tag}
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, like, config_tag: str = ""):
    """Restore a state written by save_state (this package's or lc3jax's).
    `like` gives the structure, shapes, dtypes and device (e.g. a fresh
    decoder_init or encoder_init state); the result's tensors are on like's
    device.

    Raises ValueError on missing or extra leaves, a shape or dtype change,
    or a config_tag that differs from the saved one."""
    with np.load(path) as data:
        if _META_KEY not in data.files:
            raise ValueError(f"{path} is not a lc3jax v{_FORMAT_VERSION} checkpoint "
                             "(missing metadata; re-save with save_state)")
        meta = json.loads(bytes(data[_META_KEY].tobytes()).decode("utf-8"))
        if config_tag and meta.get("config_tag") and meta["config_tag"] != config_tag:
            raise ValueError(f"checkpoint config mismatch: saved {meta['config_tag']!r}, "
                             f"expected {config_tag!r}")
        want = dict(_leaves(like))
        saved = set(data.files) - {_META_KEY}
        missing = [k for k in want if k not in saved]
        extra = sorted(saved - set(want))
        if missing or extra:
            raise ValueError(f"checkpoint field mismatch: missing {missing}, unexpected {extra}")
        restored = {}
        for key, ref in want.items():
            a = data[key]
            want_dtype = torch.zeros((), dtype=ref.dtype).numpy().dtype
            if a.shape != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {a.shape} != expected "
                                 f"{tuple(ref.shape)}")
            if a.dtype != want_dtype:
                raise ValueError(f"checkpoint leaf {key}: dtype {a.dtype} != expected "
                                 f"{want_dtype}")
            restored[key] = torch.as_tensor(a, device=ref.device)
    return _rebuild(like, restored)
