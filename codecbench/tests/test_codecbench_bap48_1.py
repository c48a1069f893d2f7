"""The check that decides `correct` in the cell `enc.bap48_1` (BAP 48_1:
48 kHz, 7.5 ms frames, 75 B): the control, the reference in bfloat16 in the
program's place, is not correct there. The program's own run at this
setting is held to the reference in `tests/test_torch_bap48_1.py`."""

from codecbench.tests.test_codecbench_check import _run


def test_the_control_is_not_correct_at_7_5_ms():
    result, checks = _run("enc.bap48_1", control=True)
    assert not result["correct"], checks
    assert checks["frames_differing"][0] > 0
