"""The committed decode corpus is what the benchmark's reference encoder
makes from the mix's pool, and every cell's inputs follow from its seed."""

import numpy as np
import pytest

from codecbench import make_corpus, spec, traffic


@pytest.mark.parametrize("config,clips", [("bap16_2.s2048", [1, 30]),
                                          ("bap48_4.s2048", [2, 60])])
def test_corpus_is_remade_exactly(config, clips):
    cfg, mix = spec.config(config), spec.traffic("closed.decode")
    with np.load(spec.corpus_path(cfg, mix)) as z:
        frames, concealed, kinds = z["frames"], z["concealed"], z["kinds"]
    assert frames.shape == (mix["clips_per_class"] * 5, mix["frames_per_clip"], cfg["nbytes"])
    got = make_corpus.make(cfg, mix, clips=clips)
    assert np.array_equal(got["frames"], frames[clips])
    assert np.array_equal(got["concealed"], concealed[clips])
    assert np.array_equal(got["kinds"], kinds[clips])


def test_class_counts_follow_the_shares():
    shares = spec.traffic("closed.decode")["shares"]
    counts = traffic.class_counts(shares, 2048)
    assert counts.sum() == 2048
    assert list(counts) == [1024, 410, 102, 307, 205]


@pytest.mark.parametrize("mix", ["closed.decode", "closed.encode"])
def test_inputs_come_from_the_seed(mix):
    cfg = spec.config("bap16_2.s2048")
    m = spec.traffic(mix)
    m["clips_per_class"] = 2 if mix == "closed.encode" else m["clips_per_class"]
    big = 2 ** 31 + 12345
    a, b, c = (traffic.Traffic(cfg, m, s, 64) for s in (big, big, big + 1))
    for b_ in (0, 7, 199, 200):
        assert np.array_equal(a.batch(b_), b.batch(b_))
    assert np.array_equal(a.batch(3), a.batch(203))  # the inputs repeat every clip
    assert not np.array_equal(a.clip, c.clip) or not np.array_equal(a.offset, c.offset)
    kinds = lambda t: np.bincount(t.clip // m["clips_per_class"], minlength=5)
    assert np.array_equal(kinds(a), kinds(c))  # every seed: the same classes, in another order
    assert len(a.checked) == m["checked_streams"] and len(set(a.checked)) == len(a.checked)
