"""The roofline counts: K1's and K5's least times for the 32k dump."""

import pytest

from flagbench import counts

N_VIS = 32768 * 8064


def test_k1_inventory_is_144_ops_at_width_13():
    assert counts.k1_ops_per_vis(13, 4) == 144
    assert dict(counts.k1_op_inventory(13, 4))["median"] == 12 + 2 + 61 + 1


def test_k1_bound_32k_dump():
    # operations bound it: 144 / 33.5e12 a visibility against 9 B / 3.35e12
    assert counts.k1_bound_s(N_VIS, 13, 4) * 1e3 == pytest.approx(1.136, abs=5e-4)
    assert 9 * N_VIS / counts.HBM_BYTES_PER_S < counts.k1_bound_s(N_VIS, 13, 4)


def test_k5_bound_32k_dump():
    assert counts.k5_bound_s(N_VIS) * 1e3 == pytest.approx(1.262, abs=5e-4)


def test_unknown_width_raises():
    with pytest.raises(ValueError):
        counts.k1_ops_per_vis(14, 4)
