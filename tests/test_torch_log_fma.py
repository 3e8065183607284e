"""PyTorch port: ``log_f32``'s multiply-adds need no round-to-odd.

``tests/exhaustive_log_fma.py`` at every mantissa and a few exponent terms
(the script, run by hand, takes all 255): ``numerics._fma_log`` gives
``numerics._fma``'s bits at each of the log's nine multiply-adds, each on
the same inputs.
"""
import pytest

import exhaustive_log_fma


@pytest.fixture(scope="module")
def steps():
    return exhaustive_log_fma.mantissa_steps()


def test_first_eight_multiply_adds_at_every_mantissa(steps):
    z3, y, differ = steps
    assert z3.numel() == 1 << 23 and differ == 0


@pytest.mark.parametrize("e", [-126, -125, -1, 0, 1, 2, 64, 128])
def test_ninth_multiply_add_at_every_mantissa(steps, e):
    z3, y, _ = steps
    assert exhaustive_log_fma.last_step_differ(y, z3, e) == 0
