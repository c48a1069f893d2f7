"""The check that decides `correct` in the cells of bap48_4.s8192 (BAP 48_4
at 8,192 streams, the device parse and the C++ host parse): the control,
the reference in bfloat16 in the program's place, is not correct there.
The program's own runs of both cells are held to the reference in
`tests/test_torch_bap48_4_s8192.py`."""

import pytest

from codecbench.tests.test_codecbench_check import _run


@pytest.mark.parametrize("cell", ["dec.bap48_4.s8192", "dec.bap48_4.s8192.hostparse"])
def test_the_control_is_not_correct_at_8192_streams(cell):
    result, checks = _run(cell, control=True)
    assert not result["correct"], checks
    assert checks["pcm_max_abs_lsb"][0] > checks["pcm_max_abs_lsb"][1]
