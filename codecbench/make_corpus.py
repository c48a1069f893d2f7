"""Makes a decode cell's frame corpus, once, on the CPU, with the
benchmark's own reference encoder (never the measured program):

    python -m codecbench.make_corpus --config bap48_4.s2048 --traffic closed.decode

The traffic mix names the pool (clips of each content class, frames a
clip, the corpus seed) and the file; the configuration the geometry and
the frame size. Each clip is made by `content.clip_pool` from the corpus
seed and encoded cyclically: the encoder first runs over the clip's last
LEAD_IN frames, so that frame 0 follows frame F - 1 as it does when a
stream wraps around its clip. The file holds the frames, uint8 [C, F,
nbytes], the class of each clip, and which frames the reference decoder
conceals (their side information or spectrum does not parse). Making it
again gives the same bytes (`tests/test_codecbench_corpus.py`).
"""

from __future__ import annotations

import argparse

import numpy as np

from . import content, reference, spec

LEAD_IN = 20


def make(cfg: dict, mix: dict, clips=None) -> dict:
    """The corpus arrays (all clips, or those in `clips`). Each clip is one
    stream of the reference encoder that starts LEAD_IN frames before the
    clip's end and wraps around to its frame 0 (`reference.run_streams`)."""
    c = reference.lc3_config(cfg)
    F = mix["frames_per_clip"]
    pcm, kinds = content.clip_pool(mix["corpus_seed"], mix["clips_per_class"], F, c.nf,
                                   cfg["fs"])
    idx = list(clips if clips is not None else range(len(pcm)))
    jobs = [{"direction": "encode", "cfg": cfg, "clip": pcm[i], "offset": F - LEAD_IN,
             "n": F + LEAD_IN, "control": False} for i in idx]
    frames = np.stack([out[LEAD_IN:] for out, _ in reference.run_streams(jobs)])
    concealed = np.array([[reference.conceals(c, f.tobytes()) for f in clip] for clip in frames])
    return {"frames": frames, "concealed": concealed, "kinds": kinds[idx],
            "classes": np.array(content.CLASSES)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    a = ap.parse_args()
    cfg, mix = spec.config(a.config), spec.traffic(a.traffic)
    out = spec.corpus_path(cfg, mix)
    arrays = make(cfg, mix)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out.relative_to(spec.ROOT)}: {arrays['frames'].shape} frames, "
          f"{int(arrays['concealed'].sum())} concealed by the reference decoder")


if __name__ == "__main__":
    main()
